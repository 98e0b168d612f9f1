"""Train a discriminative FVD feature extractor on the in-repo datasets.

Port of the root ``train_fvd_extractor.py``. The canonical FVD extractor is
a Kinetics-trained I3D; without one every FVD comes from random-init
``Mixed_3c`` features, comparable only within a run. The generators carry
ground-truth semantics, so this trains the I3D trunk as a multi-label
classifier on them and keeps its ``Mixed_4f`` features (832-d, globally
averaged) for FVD:

- ``--dataset caterv2|caterv1``: multi-hot over the four CATER actions
  (``generators/cater_synthetic.py``'s ``movements``);
- ``--dataset mnist``: single Moving MNIST, digit class (10) + motion axis
  (2) + motion sign (2) one-hots.

The scenes come from generator seed 1000 by default, never the chains'
seed 0. A step draws clip indices and uniform speeds from a
``torch.Generator``, composes the clips on the device, takes the mean
sigmoid cross-entropy of ``evals.i3d.LabelI3D`` (BatchNorm in train mode,
flax's update) and an AdamW step (optax's defaults: weight decay 1e-4,
decoupled and scaled by the learning rate), at a cosine learning rate per
epoch. Each epoch validates at speed 0.5, keeps the best trunk by exact-set
accuracy under ``<out>/i3d/best`` (pytorch-i3d keys, ``evals.i3d.
load_trained_extractor`` reads it) and the whole loop state under
``<out>/i3d/last``, from which a relaunch resumes. Then a calibration:
FVD of two real val halves (the floor) and of real against static clips
(frame 0 repeated), with the trained ``Mixed_4f`` features and with random
``Mixed_3c`` ones, written with the accuracies to ``<out>/provenance.json``.
``--tiny`` shrinks the flags left at their defaults; ``--device`` (default
``cuda``) is resolved before any data is built.

    python -m mage_tpu_torch.cli.train_fvd_extractor --out runs/fvd_extractor
    python -m mage_tpu_torch.cli.train_fvd_extractor --dataset mnist \\
        --out runs/fvd_extractor_mnist
    python -m mage_tpu_torch.cli.train_fvd_extractor --tiny --device cpu --out /tmp/fvdx
"""

from __future__ import annotations

import argparse
import json
import os
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from mage_tpu_torch.training import e2e

T_STORE = 24  # CATER stored frames (cater_synthetic)
ACTIONS = ("_slide", "_rotate", "_pick_place", "_contain")
TINY = dict(num_train=48, num_val=16, epochs=2, batch=4, chunk=2, calib_videos=8,
            frames_length=6)
WEIGHT_DECAY = 1e-4  # optax.adamw's default (torch.optim.AdamW's is 1e-2)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default="runs/fvd_extractor")
    p.add_argument("--dataset", default="caterv2", choices=["caterv1", "caterv2", "mnist"])
    p.add_argument("--seed", type=int, default=1000,
                   help="generator seed; keep != the e2e chains' seed 0 so extractor "
                        "training never sees eval scenes")
    p.add_argument("--num-train", type=int, default=2000)
    p.add_argument("--num-val", type=int, default=400)
    p.add_argument("--epochs", type=int, default=12)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--frames-length", type=int, default=10,
                   help="clip length; matches the e2e chains' eval clips")
    p.add_argument("--chunk", type=int, default=25)
    p.add_argument("--calib-videos", type=int, default=128)
    p.add_argument("--mnist-npz", default=None)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cpu runs without a GPU")
    args = p.parse_args(argv)
    if args.tiny:
        e2e.apply_tiny(args, p, TINY)
    return args


@dataclass
class DatasetSpec:
    """Everything the training loop needs about a dataset."""

    tag: str                 # provenance "dataset" family tag
    hw: int                  # frame side
    y_train: torch.Tensor    # (N, n_labels) multi-hot float32, on the device
    y_val: torch.Tensor
    clips_at: Callable       # (split, (B,) idx, (B, L) pos) -> clips in [-1, 1]
    positions: Callable      # ((B,) speed, L) -> (B, L) stored-frame ids
    groups: tuple            # ((name, start, end, kind{multi,onehot}), ...)
    label_names: tuple


def action_labels(metas) -> np.ndarray:
    """Scene meta -> multi-hot over ACTIONS (each of the two movers performs
    one action; cater_synthetic.sample_scene ``movements``)."""
    y = np.zeros((len(metas), len(ACTIONS)), np.float32)
    for i, m in enumerate(metas):
        for moves in m["movements"].values():
            for action, _target, _s, _e in moves:
                y[i, ACTIONS.index(action)] = 1.0
    return y


def prepare_cater(args, device) -> DatasetSpec:
    from mage_tpu_torch.cli import train_cater_e2e as tc
    from mage_tpu_torch.data.generators import cater_synthetic as cs

    dataset = "CATER-GEN-v1" if args.dataset == "caterv1" else "CATER-GEN-v2"
    ctx = 32 if args.dataset == "caterv1" else 38
    compact = cs.build_compact_cater(args.num_train, args.num_val, args.seed,
                                     dataset=dataset, context_length=ctx)
    dev = tc.upload(compact, device)

    def clips_at(split, idx, pos):
        b, length = pos.shape
        frames = tc.frames_at(dev, split, idx.repeat_interleave(length), pos.reshape(-1))
        return frames.reshape(b, length, *frames.shape[1:])

    def positions(speed, length):
        # the speed -> stored-frame map of train_cater_e2e.clip_positions
        return tc.clip_positions(speed, length)

    return DatasetSpec(
        tag=dataset, hw=128,
        y_train=torch.as_tensor(action_labels(compact["train"]["meta"]), device=device),
        y_val=torch.as_tensor(action_labels(compact["val"]["meta"]), device=device),
        clips_at=clips_at, positions=positions,
        groups=(("action", 0, len(ACTIONS), "multi"),),
        label_names=ACTIONS,
    )


def mnist_motion_labels(split: dict, digit_classes: np.ndarray) -> np.ndarray:
    """(M, 14): digit one-hot (10) + axis one-hot (2: horizontal, vertical)
    + sign one-hot (2: increasing, decreasing coordinate), from the stored
    integer trajectories."""
    ys, xs = np.asarray(split["ys"]), np.asarray(split["xs"])
    m = ys.shape[0]
    y = np.zeros((m, 14), np.float32)
    y[np.arange(m), digit_classes] = 1.0
    horizontal = xs.std(axis=1) > ys.std(axis=1)
    y[np.arange(m), 10 + (~horizontal).astype(int)] = 1.0
    moving = np.where(horizontal[:, None], xs, ys)
    delta = moving[:, 1:] - moving[:, :-1]
    # the first nonzero step decides the sign (a bounce flips later steps)
    first = delta[np.arange(m), np.argmax(np.abs(delta) > 0, axis=1)]
    y[np.arange(m), 12 + (first < 0).astype(int)] = 1.0
    return y


def prepare_mnist(args, device) -> DatasetSpec:
    from mage_tpu_torch.data import device_data as dd
    from mage_tpu_torch.data.generators import mnist_common as mc
    from mage_tpu_torch.training.e2e import to_device

    compact = dd.build_compact_single_mnist(args.num_train, args.num_val, args.seed,
                                            args.mnist_npz)
    _images, bank_labels = mc.load_digit_bank(args.mnist_npz, seed=args.seed)
    bank = dd.normalize_bank(compact["bank"], device)
    dev = {s: to_device(compact[s], device) for s in ("train", "val")}

    def clips_at(split, idx, pos):
        d = dev[split]
        b, length = pos.shape
        rows, cols = idx.repeat_interleave(length), pos.reshape(-1).long()
        flat = dd.compose_frames(bank, d["digit"][rows], d["ys"][rows, cols],
                                 d["xs"][rows, cols])
        clips = flat.reshape(b, length, *flat.shape[1:])
        return (2.0 * clips).repeat_interleave(3, dim=-1)  # [-.5, .5] gray -> rgb

    def positions(speed, length):
        return dd.clip_indices(speed, frames_length=length)

    y = {s: mnist_motion_labels(compact[s], np.asarray(bank_labels)[compact[s]["digit"]])
         for s in ("train", "val")}
    return DatasetSpec(
        tag="MovingMNIST", hw=64,
        y_train=torch.as_tensor(y["train"], device=device),
        y_val=torch.as_tensor(y["val"], device=device),
        clips_at=clips_at, positions=positions,
        groups=(("digit", 0, 10, "onehot"), ("axis", 10, 12, "onehot"),
                ("sign", 12, 14, "onehot")),
        label_names=tuple([f"digit_{i}" for i in range(10)]
                          + ["horizontal", "vertical", "positive", "negative"]),
    )


def group_accuracies(groups, pred_logits: np.ndarray, labels: np.ndarray) -> dict:
    out = {}
    for name, a, z, kind in groups:
        lg, lb = pred_logits[:, a:z], labels[:, a:z]
        if kind == "onehot":
            out[f"val_{name}_acc"] = float(np.mean(lg.argmax(-1) == lb.argmax(-1)))
        else:
            out[f"val_{name}_acc"] = float(np.mean((lg > 0) == (lb > 0.5)))
    return out


def make_optimizer(model: torch.nn.Module, lr: float) -> torch.optim.AdamW:
    """optax.adamw's defaults: b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4
    on every parameter."""
    return torch.optim.AdamW(model.parameters(), lr=lr, weight_decay=WEIGHT_DECAY)


def make_train_step(model, optimizer):
    """-> ``step(clips, labels, lr)``: the mean sigmoid cross-entropy of
    ``model`` in train mode (BatchNorm on the batch statistics, its running
    averages moved), its gradients and one AdamW step at ``lr``; returns
    the loss (a device scalar)."""

    def step(clips, labels, lr):
        model.train()
        loss = F.binary_cross_entropy_with_logits(model(clips), labels)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()
        return loss.detach()

    return step


def calibration(spec, trunk: dict, m: int, length: int, device) -> dict:
    """FVD floor (two real val halves) and static-vs-real FVD (frame 0
    repeated) with the trained Mixed_4f features and random Mixed_3c ones."""
    from mage_tpu_torch.evals import i3d
    from mage_tpu_torch.evals.fvd import compute_fvd

    idx = torch.arange(m, device=device)
    pos = spec.positions(torch.full((m,), 0.5, device=device), length)
    with torch.no_grad():
        real = spec.clips_at("val", idx, pos).float().cpu().numpy()
    half = m // 2
    static = np.repeat(real[half:, :1], length, axis=1)  # a degenerate "generator"
    rows = {}
    for name, extractor in (
        ("trained_Mixed_4f", i3d.make_extractor(trunk, 4, "Mixed_4f", device)),
        ("random_Mixed_3c", i3d.random_extractor(batch_size=4, device=device)),
    ):
        floor, reg_floor = compute_fvd(real[:half], real[half:], extractor,
                                       return_regularized=True)
        static_fvd, reg_static = compute_fvd(real[:half], static, extractor,
                                             return_regularized=True)
        rows[name] = {"floor": floor, "static": static_fvd,
                      "static_over_floor": static_fvd / max(floor, 1e-9),
                      # the port's addition: distances whose root took 1e-6 I
                      "fvd_regularized": [k for k, r in (("floor", reg_floor),
                                                         ("static", reg_static)) if r]}
    return rows


def main(argv=None):
    from mage_tpu_torch.evals.i3d import LabelI3D, init_label_i3d
    from mage_tpu_torch.models.pipeline import resolve_device
    from mage_tpu_torch.training.autoresume import save_last, try_restore_last
    from mage_tpu_torch.training.checkpoint import Checkpointer
    from mage_tpu_torch.training.e2e import draw_clips
    from mage_tpu_torch.training.lr import epoch_lr

    args = parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    print(f"device: {device}")

    spec = (prepare_mnist if args.dataset == "mnist" else prepare_cater)(args, device)
    n_labels = int(spec.y_train.shape[1])
    print(f"dataset {spec.tag}: {n_labels} labels, train multi-hot mean "
          f"{spec.y_train.mean(0).cpu().numpy().round(3)}")

    model = LabelI3D(n_labels)
    init_label_i3d(model, torch.Generator().manual_seed(args.seed))
    model.to(device)
    print(f"extractor params: {sum(p.numel() for p in model.parameters()):,}")
    optimizer = make_optimizer(model, args.lr)
    train_step = make_train_step(model, optimizer)
    length, n, b = args.frames_length, args.num_train, args.batch
    n_val = args.num_val
    eval_b = min(64, n_val)

    ckpt = Checkpointer(os.path.join(args.out, "i3d"))
    steps_per_epoch = max(n // b, 1)
    chunks = max(round(steps_per_epoch / args.chunk), 1)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    best = float("inf")
    start_epoch = 0
    resumed = try_restore_last(ckpt, map_location=device)
    if resumed is not None:
        start_epoch, best, st = resumed
        model.load_state_dict(st["model"])
        optimizer.load_state_dict(st["optimizer"])
        gen.set_state(st["rng"].cpu())
        print(f"autoresume: epoch {start_epoch}, best {best:.4f}")
    y_val = spec.y_val[:eval_b].cpu().numpy()

    @torch.no_grad()
    def val_metrics():
        model.eval()
        idx = torch.arange(eval_b, device=device)
        pos = spec.positions(torch.full((eval_b,), 0.5, device=device), length)
        logits = model(spec.clips_at("val", idx, pos)).float().cpu().numpy()
        per_label = float(np.mean((logits > 0) == (y_val > 0.5)))
        exact = float(np.mean(np.all((logits > 0) == (y_val > 0.5), -1)))
        return per_label, exact, group_accuracies(spec.groups, logits, y_val)

    # a relaunch after a finished run skips the loop; provenance.json below
    # still needs these
    per_label, exact, metrics = val_metrics()
    t0 = time.time()
    for epoch in range(start_epoch, args.epochs):
        lr = epoch_lr(args.lr, epoch, args.epochs, cos=True)
        for _ in range(chunks):
            for _ in range(args.chunk):
                idx, speed = draw_clips(gen, n, b)
                clips = spec.clips_at("train", idx, spec.positions(speed, length))
                train_step(clips, spec.y_train[idx], lr)
        per_label, exact, metrics = val_metrics()
        score = 1.0 - exact  # best-tracking proxy
        e2e.log_metrics(args.out, {
            "phase": "extractor", "epoch": epoch, "lr": lr,
            "val_action_acc_per_label": per_label,
            "val_action_acc_exact_set": exact, **metrics,
            "sec_per_epoch": (time.time() - t0) / (epoch - start_epoch + 1),
        }, name="metrics.json")
        if score < best:
            best = score
            ckpt.save("best", model.i3d.state_dict())
        save_last(ckpt, epoch, best, {"model": model.state_dict(),
                                      "optimizer": optimizer.state_dict(),
                                      "rng": gen.get_state()})

    m = min(args.calib_videos, n_val)
    rows = calibration(spec, model.i3d.state_dict(), m, length, device)
    e2e.log_metrics(args.out, {"phase": "calibration", "samples": m, **rows},
                    name="metrics.json")

    with open(os.path.join(args.out, "provenance.json"), "w") as fp:
        json.dump({
            "kind": "label-trained I3D trunk, endpoint Mixed_4f (832-d)",
            "dataset": spec.tag, "generator_seed": args.seed,
            "num_train_scenes": args.num_train, "epochs": args.epochs,
            "labels": list(spec.label_names),
            "val_action_acc_per_label": per_label,
            "val_action_acc_exact_set": exact, **metrics,
            "calibration": rows,
        }, fp, indent=1)
    print("saved", ckpt.path("best"))
    return rows


if __name__ == "__main__":
    main()
