"""Compact Moving-MNIST and CATER data, rendered on the tensors' device.

The port of ``mage_tpu/data/device_data.py``. The dataset is shipped as the
*inputs* of its generator: the digit bank (N x 28 x 28 uint8), integer
pixel trajectories and caption tokens, and the frames are pasted on the
device. The two builders are numpy and copied line for line, so they make
the generators' RNG calls in the same order; the compose and index
functions take tensors and run on their device.

Exactness contract (held against the JAX module in
``tests/test_torch_port_device_data.py``):

- ``build_compact_single_mnist`` replays ``generators.mnist_single``
  RNG-call-for-RNG-call, so the compact arrays describe the *exact*
  records the ``.mrs`` generator writes for the same seed;
  ``build_compact_double_modified`` does the same for
  ``generators.mnist_double_modified``.
- ``compose_frames`` reproduces ``mnist_common.render_video`` (a single
  digit pasted at its integer track position) after the /255 - 0.5
  normalization. Pastes are index arithmetic over (M, 28, 28) windows (one
  ``index_put`` for all M frames), each window's corner placed as
  ``jax.lax.dynamic_update_slice`` places it (``_windows``).
- ``clip_indices`` reproduces ``datasets.speed_subsample_indices`` (the
  interval from the speed, the linspace pick, repeat-last padding to
  ``frames_length``) in exact integer math, so speed-conditioned clips are
  gathers of per-frame latents.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mage_tpu_torch.data.generators import mnist_common as mc

SEQ_LENGTH = 20  # stored frames per clip (mnist_single.SEQ_LENGTH)
IMAGE_SIZE = mc.IMAGE_SIZE
DIGIT_SIZE = mc.DIGIT_SIZE


def build_compact_single_mnist(
    num_train: int,
    num_val: int,
    seed: int = 0,
    mnist_npz: Optional[str] = None,
) -> dict:
    """-> {"bank": uint8 (N, 28, 28),
           "train"/"val": {"digit" (M,), "ys"/"xs" (M, 20), "text" (M, 32)}}.

    Follows generators/mnist_single.py's exact RNG sequence (digit pick,
    motion pick, direction, trajectory) so the described dataset is
    byte-identical to the record store the generator writes for ``seed``.
    """
    from mage_tpu_torch.data.tokenizers import MNIST_VOCAB, VocabTokenizer

    rng = np.random.RandomState(seed)
    images, labels = mc.load_digit_bank(mnist_npz, seed=seed)
    train_codes, val_codes = mc.digit_motion_split(rng)
    tokenizer = VocabTokenizer(MNIST_VOCAB, split_mode="whitespace")

    def build_split(codes: np.ndarray, num: int) -> dict:
        digits, motions = codes % 10, codes // 10
        idx, ys, xs, text = [], [], [], []
        while len(idx) < num:
            # identical call order to mnist_single.generate_split /
            # generate_instance: randint(bank), choice(matches),
            # randint(direction), then bounce_trajectory's two rand()s
            i = rng.randint(images.shape[0])
            label = int(labels[i])
            matches = np.where(digits == label)[0]
            if len(matches) == 0:
                continue
            motion = int(motions[rng.choice(matches)])
            direction = int(rng.randint(0, 2))
            ty, tx = mc.bounce_trajectory(SEQ_LENGTH, rng, motion, direction)
            caption = "the digit %d is moving %s ." % (
                label, mc.MOTION_STRINGS[motion + 2 * direction]
            )
            idx.append(i)
            ys.append(ty)
            xs.append(tx)
            text.append(tokenizer.encode_padded(caption, 32))
        return {
            "digit": np.asarray(idx, np.int32),
            "ys": np.stack(ys).astype(np.int32),
            "xs": np.stack(xs).astype(np.int32),
            "text": np.stack(text).astype(np.int32),
        }

    return {
        "bank": images,
        "train": build_split(train_codes, num_train),
        "val": build_split(val_codes, num_val),
    }


def build_compact_double_modified(
    num_train: int,
    num_val: int,
    seed: int = 0,
    mnist_npz: Optional[str] = None,
    context_length: int = 32,
    bank: Optional[tuple] = None,
) -> dict:
    """Compact device-resident Modified Double Moving MNIST
    (reference data/mnist_caption_double_modified.py; generator parity:
    ``generators.mnist_double_modified``).

    Replays the .mrs generator's exact RNG call order (digit-pair pick,
    combo choice, distractor-digit rejection, per-digit direction/bounce +
    trajectory, distractor presence + IOU placement), so the compact
    arrays describe the same records ``mnist_double_modified.main`` writes
    for ``seed``. Variable-length tracks (digits freeze at walls) are
    edge-padded to SEQ_LENGTH+1 — physically exact continuation (a stopped
    digit stays put) — with the TRUE length kept in ``length`` so
    speed subsampling sees the same frame count as the written records.

    -> {"bank", split: {"d1","d2" (M,), "ys1","xs1","ys2","xs2" (M, 21),
        "length" (M,), "bg" (M,), "bg_y","bg_x" (M,), "has_bg" (M,),
        "text" (M, context_length)}}
    """
    from mage_tpu_torch.data.generators.mnist_double import MOTION_IDXS, pair_motion_split
    from mage_tpu_torch.data.generators.mnist_double_modified import (
        MOTION_STRINGS as MOD_MOTION_STRINGS,
        SEQ_LENGTH as MOD_SEQ,
        _iou_overlaps,
        modified_trajectory,
    )
    from mage_tpu_torch.data.tokenizers import MNIST_VOCAB, VocabTokenizer

    rng = np.random.RandomState(seed)
    images, labels = (
        mc.load_digit_bank(mnist_npz, seed=seed) if bank is None else bank
    )
    train_codes, val_codes = pair_motion_split(rng)
    tokenizer = VocabTokenizer(MNIST_VOCAB, split_mode="whitespace")
    tmax = MOD_SEQ + 1

    def build_split(codes: np.ndarray, num: int) -> dict:
        pair_codes, combo_codes = codes % 100, codes // 100
        cols = {k: [] for k in ("d1", "d2", "ys1", "xs1", "ys2", "xs2",
                                "length", "bg", "bg_y", "bg_x", "has_bg",
                                "text")}
        while len(cols["d1"]) < num:
            idxs = rng.randint(images.shape[0], size=2)
            pair = 10 * int(labels[idxs[0]]) + int(labels[idxs[1]])
            matches = np.where(pair_codes == pair)[0]
            if len(matches) == 0:
                continue
            combo = int(combo_codes[rng.choice(matches)])
            while True:  # distractor digit differs from both movers
                bg = int(rng.randint(images.shape[0]))
                if labels[bg] not in (labels[idxs[0]], labels[idxs[1]]):
                    break
            motions = MOTION_IDXS[combo]
            tracks, dirs, bounces = [], [], []
            for m in motions:
                d, bn = int(rng.randint(0, 2)), int(rng.randint(0, 2))
                tracks.append(modified_trajectory(rng, int(m), d, bn))
                dirs.append(d)
                bounces.append(bn)
            tlen = max(t[0].shape[0] for t in tracks)
            tracks = [
                (np.pad(ys, (0, tmax - len(ys)), mode="edge"),
                 np.pad(xs, (0, tmax - len(xs)), mode="edge"))
                for ys, xs in tracks
            ]
            has_bg = int(rng.randint(0, 2))
            bg_y = bg_x = 0
            if has_bg:
                boxes = [
                    (int(t[0][0]), int(t[1][0]),
                     int(t[0][0]) + DIGIT_SIZE, int(t[1][0]) + DIGIT_SIZE)
                    for t in tracks
                ]
                while True:
                    bg_y = int((IMAGE_SIZE - DIGIT_SIZE) * rng.rand())
                    bg_x = int((IMAGE_SIZE - DIGIT_SIZE) * rng.rand())
                    box = (bg_y, bg_x, bg_y + DIGIT_SIZE, bg_x + DIGIT_SIZE)
                    if not any(_iou_overlaps(box, b) for b in boxes):
                        break
            caption = (
                "the digit %d is moving %s and the digit %d is moving %s ."
                % (
                    labels[idxs[0]],
                    MOD_MOTION_STRINGS[int(motions[0]) + 2 * dirs[0] + 4 * bounces[0]],
                    labels[idxs[1]],
                    MOD_MOTION_STRINGS[int(motions[1]) + 2 * dirs[1] + 4 * bounces[1]],
                )
            )
            cols["d1"].append(int(idxs[0]))
            cols["d2"].append(int(idxs[1]))
            cols["ys1"].append(tracks[0][0])
            cols["xs1"].append(tracks[0][1])
            cols["ys2"].append(tracks[1][0])
            cols["xs2"].append(tracks[1][1])
            cols["length"].append(tlen)
            cols["bg"].append(bg)
            cols["bg_y"].append(bg_y)
            cols["bg_x"].append(bg_x)
            cols["has_bg"].append(has_bg)
            cols["text"].append(tokenizer.encode_padded(caption, context_length))
        return {
            k: (np.stack(v) if k in ("ys1", "xs1", "ys2", "xs2", "text")
                else np.asarray(v)).astype(np.int32)
            for k, v in cols.items()
        }

    return {
        "bank": images,
        "train": build_split(train_codes, num_train),
        "val": build_split(val_codes, num_val),
    }


def _windows(top: torch.Tensor, left: torch.Tensor, size: int, canvas: int):
    """(M,) window corners -> the (M, size, 1) rows and (M, 1, size) columns
    of each window. The corner is placed as ``jax.lax.dynamic_slice`` and
    ``dynamic_update_slice`` place it: a negative start counts from the end
    of the canvas, then the start is clamped to [0, canvas - size] so that
    the window fits."""

    def place(start):
        start = start.long()
        return torch.where(start < 0, start + canvas, start).clamp(0, canvas - size)

    top, left = place(top), place(left)
    span = torch.arange(size, device=top.device)
    return (top[:, None] + span)[:, :, None], (left[:, None] + span)[:, None, :]


def _paste(background: torch.Tensor, patches: torch.Tensor, top: torch.Tensor,
           left: torch.Tensor) -> torch.Tensor:
    """(M, P, P, ...) patches written over copies of ``background`` (H, W,
    ...) at the (M,) corners -> (M, H, W, ...)."""
    m, size = patches.shape[:2]
    out = background.expand(m, *background.shape).clone()
    rows, cols = _windows(top, left, size, background.shape[0])
    frame = torch.arange(m, device=out.device)[:, None, None]
    out[frame, rows, cols] = patches
    return out


def compose_frames_double(
    bank: torch.Tensor,  # (N, 28, 28) normalized
    d1: torch.Tensor, y1: torch.Tensor, x1: torch.Tensor,  # (M,) each
    d2: torch.Tensor, y2: torch.Tensor, x2: torch.Tensor,
    bg: torch.Tensor, bg_y: torch.Tensor, bg_x: torch.Tensor, has_bg: torch.Tensor,
) -> torch.Tensor:
    """Render M two-digit (+ optional static distractor) frames
    -> (M, 64, 64, 1). Overlap composite = max, like render_video (the
    normalization is monotonic, so max commutes with /255-0.5)."""
    background = torch.full((IMAGE_SIZE, IMAGE_SIZE), -0.5, dtype=bank.dtype,
                            device=bank.device)

    def paste(d, y, x):
        return _paste(background, bank[d.long()], y, x)

    frame = torch.maximum(paste(d1, y1, x1), paste(d2, y2, x2))
    dist = torch.where((has_bg > 0)[:, None, None], paste(bg, bg_y, bg_x), background)
    return torch.maximum(frame, dist)[..., None]


def clip_indices_var(
    speed: torch.Tensor, length: torch.Tensor, frames_length: int = 16
) -> torch.Tensor:
    """speed in [0, 1), clip length (same shape) -> (..., frames_length)
    int32 indices.

    Variable-length twin of ``clip_indices`` for datasets whose videos end
    early (modified-double: digits freeze at walls). count =
    round_half_even(length / (1 + speed)) like speed_subsample_indices
    (sample_speed [1, 2], min_interval 1), the quotient in f32 as the JAX
    module computes it; ``torch.round`` is half-to-even like the
    generator's float64 np.round. Index floor(linspace) in exact integer
    math, repeat-last padded."""
    length = torch.as_tensor(length).to(torch.int32)[..., None]
    speed = torch.as_tensor(speed).to(torch.float32)[..., None]
    q = length.to(torch.float32) / (1.0 + speed)
    count = torch.clamp(torch.round(q).to(torch.int32), min=1)
    i = torch.minimum(torch.arange(frames_length, dtype=torch.int32, device=count.device),
                      count - 1)
    return (i * (length - 1)) // torch.clamp(count - 1, min=1)


def normalize_bank(bank: np.ndarray, device=None) -> torch.Tensor:
    """uint8 digit bank -> float32 in [-0.5, 0.5] on ``device`` (the
    transform chain's ToFloat + Normalize used by the MNIST configs).

    Computed on the CPU, then moved: CUDA divides a tensor by a Python
    scalar as a product with its reciprocal, one ulp off the true quotient
    that XLA, numpy and the CPU compute."""
    normalized = torch.as_tensor(np.asarray(bank)).to(torch.float32) / 255.0 - 0.5
    return normalized.to(device)


def compose_frames(
    bank: torch.Tensor,  # (N, 28, 28) normalized
    digit: torch.Tensor,  # (M,) bank indices
    ys: torch.Tensor,  # (M,) integer top coordinates
    xs: torch.Tensor,  # (M,) integer left coordinates
) -> torch.Tensor:
    """Render M independent frames -> (M, 64, 64, 1) in the bank's dtype.

    Single-digit paste at the integer track position == render_video's
    max-composite for one digit (background is the normalized zero level).
    """
    background = torch.full((IMAGE_SIZE, IMAGE_SIZE), -0.5, dtype=bank.dtype,
                            device=bank.device)
    return _paste(background, bank[digit.long()], ys, xs)[..., None]


def compose_clip(
    bank: torch.Tensor,
    digit: torch.Tensor,  # scalar bank index
    ys: torch.Tensor,  # (SEQ_LENGTH,)
    xs: torch.Tensor,  # (SEQ_LENGTH,)
    pos: torch.Tensor,  # (L,) frame indices into the stored trajectory
) -> torch.Tensor:
    """One speed-subsampled clip -> (L, 64, 64, 1)."""
    pos = pos.long()
    length = pos.shape[0]
    return compose_frames(bank, torch.as_tensor(digit, device=bank.device).expand(length),
                          ys[pos], xs[pos])


def compose_frames_cater(
    bank: torch.Tensor,  # (K, 32, 32, 4) float sprites, alpha in [..., 3]
    background: torch.Tensor,  # (128, 128, 3) float
    sid: torch.Tensor,  # (M, S) sprite ids, painter's order
    top: torch.Tensor,  # (M, S)
    left: torch.Tensor,  # (M, S)
) -> torch.Tensor:
    """Render M synthetic-CATER frames -> (M, 128, 128, 3).

    Sequential alpha-masked paste per slot (gather the window, blend where
    alpha > 0, write it back), the corner placed as ``dynamic_slice``
    places it: the twin of
    generators/cater_synthetic.render_frame, bit-identical on
    uint8-scaled inputs."""
    m, slots = sid.shape
    sp = bank.shape[1]
    img = background.expand(m, *background.shape).clone()
    frame = torch.arange(m, device=img.device)[:, None, None]
    for s in range(slots):  # S is small (4): painter's order
        rows, cols = _windows(top[:, s], left[:, s], sp, background.shape[0])
        spr = bank[sid[:, s].long()]
        patch = img[frame, rows, cols]
        img[frame, rows, cols] = torch.where(spr[..., 3:4] > 0, spr[..., :3], patch)
    return img


def _count_thresholds(seq_length: int) -> np.ndarray:
    """Largest float32 speed for which round(seq/interval) >= k, for
    k = seq//2+1 .. seq (interval = 1 + speed, sample_speed [1, 2]).

    count >= k  <=>  seq/(1+s) >= k - 0.5  <=>  s <= (2*seq - (2k-1))/(2k-1).
    The rational threshold is computed in float64 and rounded *down* to
    float32 so the traced comparison ``s <= t`` is exact for every float32
    s (ties at exactly k-0.5 are unreachable: the rational thresholds have
    odd denominators, hence are never float32 values).
    """
    ks = np.arange(seq_length // 2 + 1, seq_length + 1)
    exact = (2.0 * seq_length - (2 * ks - 1)) / (2 * ks - 1)
    t = exact.astype(np.float32)
    bad = t.astype(np.float64) > exact
    t[bad] = np.nextafter(t[bad], np.float32(-np.inf))
    return t


def clip_indices(
    speed: torch.Tensor, frames_length: int = 16, seq_length: int = SEQ_LENGTH
) -> torch.Tensor:
    """speed in [0, 1) (any shape) -> (..., frames_length) int32
    stored-frame indices.

    Exact replica of ``speed_subsample_indices(seq_length, [1.0, 2.0],
    speed, 1.0)`` truncated to ``frames_length`` and padded by repeating
    the last picked frame (reference dataload.py:246-258):

    - interval = 1 + speed, count = round_half_even(seq_length / interval),
      computed by comparing speed against precomputed exact thresholds;
    - index_i = floor(linspace(0, seq-1, count))_i == (i*(seq-1)) // (count-1)
      in integer math (denominators <= seq-1 make the float64 linspace and
      the rational floor provably agree).
    """
    speed = torch.as_tensor(speed).to(torch.float32)
    thresholds = torch.as_tensor(_count_thresholds(seq_length), device=speed.device)
    count = seq_length // 2 + torch.sum(
        (speed[..., None] <= thresholds).to(torch.int32), dim=-1, dtype=torch.int32
    )[..., None]
    i = torch.minimum(torch.arange(frames_length, dtype=torch.int32, device=speed.device),
                      count - 1)
    return (i * (seq_length - 1)) // torch.clamp(count - 1, min=1)
