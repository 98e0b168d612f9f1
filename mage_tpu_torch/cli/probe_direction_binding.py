"""Does generation follow the caption's direction words?

Port of the root ``probe_direction_binding.py``, over a
``cli.train_mnist_e2e`` run. Teacher-forced CE barely moves under
direction-word swaps (``probe_text_sensitivity``), so the test is
generative: the same first frame is generated at speed 0.5 under

  (a) the true caption,
  (b) the sign-swapped caption (up<->down, left<->right),
  (c) the axis-swapped caption (up<->left, down<->right),

in one batched cached generate, and the digit's initial motion (the
thresholded-centroid displacement at generated frame ``--frames``) is held
against the caption's first direction word. Cases with less than
``--min-room`` px of head-room along the commanded direction are left out
(a wall would stop the digit). The ``gt_ceiling`` line applies the same
window, gating and tracker to ground-truth clips; ``--ceiling-only`` stops
there and loads no model. The generator's prior noise comes from a
generator seeded 7 (the JAX probe's ``PRNGKey(7)`` cannot be reproduced).

Every flag this parser does not know goes to ``train_mnist_e2e``'s parser
(the run's ``--num-train``, ``--num-val``, ``--tiny``, ...). ``--device``
(default ``cuda``) is resolved before any data is built.

    python -m mage_tpu_torch.cli.probe_direction_binding --run runs/mnist_e2e_full
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

# MNIST_VOCAB direction tokens and their screen-space motion
# (y grows downward): up = -y, down = +y, left = -x, right = +x
DIR_TOKENS = {24: (-1, 0), 25: (1, 0), 26: (0, -1), 27: (0, 1)}
SIGN_SWAP = {24: 25, 25: 24, 26: 27, 27: 26}
AXIS_SWAP = {24: 26, 26: 24, 25: 27, 27: 25}
VARIANTS = {"true": None, "sign_swap": SIGN_SWAP, "axis_swap": AXIS_SWAP}


def swap_tokens(text, mapping: dict):
    """``text`` (a numpy array or a tensor) with each token a of ``mapping``
    replaced by ``mapping[a]`` (read from the original, so swaps compose)."""
    out = text.clone() if isinstance(text, torch.Tensor) else text.copy()
    for a, b in mapping.items():
        out[text == a] = b
    return out


def first_direction(text_row):
    """The motion (dy, dx) of the first direction word in a caption row, or
    None."""
    for tok in text_row:
        if int(tok) in DIR_TOKENS:
            return DIR_TOKENS[int(tok)]
    return None


def head_room(want, y0: int, x0: int, span: int) -> int:
    """Px between the digit's top-left (y0, x0) and the wall it is sent to."""
    if want[0] != 0:
        return (span - y0) if want[0] > 0 else y0
    return (span - x0) if want[1] > 0 else x0


def score(cases, min_room: int) -> dict:
    """Agreement of measured initial displacements with commanded directions.

    ``cases``: (want (dy, dx) or None, head-room px, ``disp()`` -> measured
    (dy, dx)); a case without a direction is not counted, one with less
    than ``min_room`` px is counted as ``skipped`` and not measured. The
    axis agrees when the larger displacement component is the commanded
    axis; the sign is scored among those. Fractions are nan over no case."""
    ok_axis = ok_sign = n_axis_ok = n = skipped = 0
    for want, room, disp in cases:
        if want is None:
            continue
        if room < min_room:
            skipped += 1
            continue
        dy, dx = (float(v) for v in disp())
        axis_is_y = abs(dy) >= abs(dx)
        want_y = want[0] != 0
        ok_axis += int(axis_is_y == want_y)
        if axis_is_y == want_y:
            n_axis_ok += 1
            comp, want_sign = (dy, want[0]) if want_y else (dx, want[1])
            ok_sign += int(np.sign(comp) == want_sign)
        n += 1
    return {"axis_agree": ok_axis, "n": n, "sign_agree": ok_sign,
            "n_axis_agree": n_axis_ok, "wall_blocked": skipped,
            "axis_frac": ok_axis / n if n else math.nan,
            "sign_given_axis_frac": ok_sign / n_axis_ok if n_axis_ok else math.nan}


def print_score(name: str, s: dict) -> None:
    print(f"{name:10s}: axis agreement {s['axis_agree']}/{s['n']} "
          f"({100 * s['axis_agree'] / max(s['n'], 1):.0f}%), sign given axis "
          f"{s['sign_agree']}/{s['n_axis_agree']} "
          f"({100 * s['sign_agree'] / max(s['n_axis_agree'], 1):.0f}%), "
          f"{s['wall_blocked']} wall-blocked cases excluded")


def displacement(video: torch.Tensor, start: torch.Tensor, frames: int) -> torch.Tensor:
    """(G, L-1, 64, 64, 1) generated frames -> (G, 2) thresholded-centroid
    displacement at generated frame ``frames`` from ``start`` (G, 2)."""
    from mage_tpu_torch.cli.eval_speed_control import centroid_track

    return centroid_track(video)[:, frames - 1] - start


def parse_args(argv=None):
    """-> (this CLI's arguments, ``train_mnist_e2e``'s arguments for the run)."""
    from mage_tpu_torch.cli import train_mnist_e2e

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--run", default="runs/mnist_e2e_full")
    p.add_argument("--ckpt", default="final")
    p.add_argument("--videos", type=int, default=32)
    p.add_argument("--frames", type=int, default=1,
                   help="initial generated frames over which direction is measured: "
                        "ground-truth motion at speed 0.5 is ~9 px/frame, so windows over "
                        "2 frames cross the 36 px span and bounce (the gt_ceiling line "
                        "validates any (frames, min-room) choice)")
    p.add_argument("--min-room", type=int, default=12,
                   help="px of head-room required along the commanded direction")
    p.add_argument("--ceiling-only", action="store_true",
                   help="only the measurement ceiling on ground-truth clips; no model")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cpu runs the kernels' plain versions")
    args, rest = p.parse_known_args(argv)
    targs = train_mnist_e2e.parse_args(["--out", args.run, "--device", args.device, *rest])
    return args, targs


@torch.no_grad()
def generate_variants(pipeline, lat0: torch.Tensor, texts: dict) -> torch.Tensor:
    """One batched cached generate of the first-frame ids ``lat0`` (G, h, w)
    under each caption of ``texts`` at speed 0.5 -> decoded frames
    (V, G, L-1, 64, 64, 1); prior noise from a generator seeded 7."""
    device = pipeline.device
    v, g = len(texts), lat0.shape[0]
    speed = torch.full((v * g,), 0.5, dtype=torch.float32, device=device)
    gen = pipeline.core.generate_cached(
        lat0[:, None].repeat(v, 1, 1, 1), torch.cat(list(texts.values())), speed,
        generator=torch.Generator(device=device).manual_seed(7))
    video = pipeline.first_stage.decode(gen)
    return video.reshape(v, g, *video.shape[1:])


def pair_mse(video: torch.Tensor) -> dict:
    """How far the swapped captions moved the video (a hedge detector)."""
    return {"mse_true_vs_sign_swap": float(torch.mean((video[0] - video[1]) ** 2)),
            "mse_true_vs_axis_swap": float(torch.mean((video[0] - video[2]) ** 2))}


def main(argv=None):
    from mage_tpu_torch.cli import train_mnist_e2e as tm
    from mage_tpu_torch.cli.eval_fvd_e2e import restore_run
    from mage_tpu_torch.cli.eval_speed_control import centroid_track
    from mage_tpu_torch.data import device_data as dd
    from mage_tpu_torch.models.pipeline import resolve_device

    args, targs = parse_args(argv)
    device = resolve_device(args.device)
    if args.ceiling_only:
        dev = tm.upload(dd.build_compact_single_mnist(targs.num_train, targs.num_val,
                                                      targs.seed, targs.mnist_npz), device)
    else:
        dev, model, pipeline = restore_run(targs, device, args.ckpt)
    val, bank = dev["val"], dev["bank"]
    g = min(args.videos, int(val["digit"].shape[0]))
    length = targs.frames_length
    span = dd.IMAGE_SIZE - dd.DIGIT_SIZE
    text_true = val["text"][:g]
    host_text = text_true.cpu().numpy()
    ys0, xs0 = val["ys"][:g, 0].tolist(), val["xs"][:g, 0].tolist()
    # start: the tracked centroid of the true frame 0 (the box corner plus
    # the digit's ink offset, a bias that matters at 1-2-frame windows)
    f0 = dd.compose_frames(bank, val["digit"][:g], val["ys"][:g, 0], val["xs"][:g, 0])
    start = centroid_track(f0[:, None])[:, 0]

    def column(txt, disp):
        disp = disp.cpu().numpy()
        cases = []
        for i in range(g):
            want = first_direction(txt[i])
            room = head_room(want, ys0[i], xs0[i], span) if want else 0
            cases.append((want, room, lambda i=i: disp[i]))
        return score(cases, args.min_room)

    # the measurement ceiling: the same window, gating and tracker on the
    # ground-truth clips at speed 0.5 (generated frames are stored frames pos[1:])
    pos = dd.clip_indices(torch.tensor(0.5, device=device), frames_length=length).long()[1:]
    gt = dd.compose_frames(bank, val["digit"][:g].repeat_interleave(length - 1),
                           val["ys"][:g][:, pos].reshape(-1), val["xs"][:g][:, pos].reshape(-1))
    rec = {"run": args.run, "videos": g, "frames": args.frames, "min_room": args.min_room,
           "gt_ceiling": column(host_text, displacement(
               gt.reshape(g, length - 1, *gt.shape[1:]), start, args.frames))}
    print_score("gt_ceiling", rec["gt_ceiling"])
    if not args.ceiling_only:
        texts = {name: text_true if m is None else swap_tokens(text_true, m)
                 for name, m in VARIANTS.items()}
        with torch.no_grad():
            video = generate_variants(pipeline, model.encode(f0).to(torch.int32), texts)
        rec.update(pair_mse(video))
        print(f"\npairwise video MSE true-vs-sign_swap: {rec['mse_true_vs_sign_swap']:.3e}, "
              f"true-vs-axis_swap: {rec['mse_true_vs_axis_swap']:.3e}\n")
        for vi, (name, txt) in enumerate(texts.items()):
            rec[name] = column(txt.cpu().numpy(), displacement(video[vi], start, args.frames))
            print_score(name, rec[name])
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
