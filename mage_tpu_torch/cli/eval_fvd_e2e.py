"""FVD of a trained Moving-MNIST e2e run.

Port of the root ``eval_fvd_e2e.py``. Restores the stage-1 and stage-2
checkpoints a ``cli.train_mnist_e2e`` run wrote (``<run>/vqvae/best``,
``<run>/mage/best``, or ``<run>/mage/final`` when there is no best),
regenerates the val videos with the cached sampler at speed 0.5, and
computes FVD(generated, ground truth) and FVD(VQ reconstruction, ground
truth), the first stage's floor, with the same-split floor of the real set
beside them, through ``evals.fvd.resolve_extractor`` (``--i3d-checkpoint``,
then ``--fvd-extractor``, then the default trained extractors, then the
random-init ``Mixed_3c`` one). The record is appended to
``<run>/e2e_metrics.json`` (or ``--out``).

Every flag this parser does not know goes to ``train_mnist_e2e``'s parser,
which rebuilds the run's dataset and models: pass the run's own
``--num-train``, ``--num-val``, ``--tiny``, ``--dim``, ... so the val split and
the widths are the run's. ``--device`` (default ``cuda``) is resolved before
any data is built.

    python -m mage_tpu_torch.cli.eval_fvd_e2e --run runs/mnist_e2e --videos 64 \\
        --fvd-extractor runs/fvd_extractor_mnist
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from mage_tpu_torch.cli.train_mnist2_e2e import to_rgb
from mage_tpu_torch.training import e2e


def parse_args(argv=None):
    """-> (this CLI's arguments, ``train_mnist_e2e``'s arguments for the run)."""
    from mage_tpu_torch.cli import train_mnist_e2e

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--run", default="runs/mnist_e2e_full")
    p.add_argument("--videos", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--frames-length", type=int, default=16)
    p.add_argument("--out", default=None, help="default: <run>/e2e_metrics.json")
    e2e.add_fvd_extractor_args(p)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cpu runs the kernels' plain versions")
    args, rest = p.parse_known_args(argv)
    targs = train_mnist_e2e.parse_args(
        ["--out", args.run, "--seed", str(args.seed), "--frames-length",
         str(args.frames_length), "--eval-videos", str(args.videos),
         "--device", args.device, *rest])
    return args, targs


def restore_run(targs, device, ckpt=None):
    """The run's dataset on ``device`` (the same seed and counts, so the val
    split is the run's), its VQ-VAE (``vqvae/best``) and pipeline with the
    stage-2 core of ``mage/<ckpt>`` (by default ``best``, ``final`` when the
    run saved no best) -> (dev, vqvae, pipeline)."""
    from mage_tpu_torch.cli import train_mnist_e2e as tm
    from mage_tpu_torch.data import device_data as dd
    from mage_tpu_torch.training.checkpoint import Checkpointer

    compact = dd.build_compact_single_mnist(targs.num_train, targs.num_val, targs.seed,
                                            targs.mnist_npz)
    dev = tm.upload(compact, device)
    model = tm.make_vqvae(targs, device)
    model.load_state_dict(Checkpointer(os.path.join(targs.out, "vqvae")).restore(
        "best", device)["state_dict"])
    model.eval()
    pipeline = tm.build_pipeline(targs, model, device)
    mage = Checkpointer(os.path.join(targs.out, "mage"))
    if ckpt is None:
        ckpt = "best" if mage.exists("best") else "final"
    pipeline.core.load_state_dict(mage.restore(ckpt, device)["model"])
    return dev, model, pipeline


@torch.no_grad()
def generate_val(targs, dev, model, pipeline, g: int):
    """The first ``g`` val clips at speed 0.5: (generated frames 1..L-1,
    their ground truth, its VQ reconstruction), each (g, L-1, 64, 64, 1) on
    the host; the prior noise from a generator seeded 7."""
    from mage_tpu_torch.cli import train_mnist_e2e as tm
    from mage_tpu_torch.data import device_data as dd

    device = pipeline.device
    ids_val = tm.materialize_latents(targs, model, dev, "val", device)
    d = dev["val"]
    speed = torch.full((g,), 0.5, dtype=torch.float32, device=device)
    pos = dd.clip_indices(speed, frames_length=targs.frames_length).long()
    gen = pipeline.core.generate_cached(
        ids_val[:g, :1], d["text"][:g], speed,
        generator=torch.Generator(device=device).manual_seed(7))
    video = pipeline.first_stage.decode(gen)
    length = pos.shape[1]
    rows = torch.arange(g, device=device)
    gt = tm.frames_at(dev, "val", rows.repeat_interleave(length), pos.reshape(-1))
    gt = gt.reshape(g, length, *gt.shape[1:])
    recon = pipeline.first_stage.decode(ids_val[:g][rows[:, None], pos])
    return tuple(t.float().cpu().numpy() for t in (video, gt[:, 1:], recon[:, 1:]))


def main(argv=None):
    from mage_tpu_torch.evals.fvd import (compute_fvd, fvd_same_split_floor,
                                          resolve_extractor)
    from mage_tpu_torch.models.pipeline import resolve_device

    args, targs = parse_args(argv)
    device = resolve_device(args.device)
    dev, model, pipeline = restore_run(targs, device)
    g = min(args.videos, int(dev["val"]["digit"].shape[0]))
    video, gt, recon = generate_val(targs, dev, model, pipeline, g)

    extractor, provenance, feature_dim = resolve_extractor(
        "MovingMNIST", batch_size=8, i3d_checkpoint=args.i3d_checkpoint,
        extractor_dir=args.fvd_extractor, device=device)
    fvd_gen, reg_gen = compute_fvd(to_rgb(gt), to_rgb(video), extractor,
                                   return_regularized=True)
    fvd_recon, reg_recon = compute_fvd(to_rgb(gt), to_rgb(recon), extractor,
                                       return_regularized=True)
    fvd_floor, reg_floor = fvd_same_split_floor(to_rgb(gt), extractor,
                                                return_regularized=True)
    mse = float(((video - gt) ** 2).mean())
    record = {
        "phase": "fvd_val", "samples": g,
        "fvd_gen_vs_gt": float(fvd_gen),
        "fvd_recon_vs_gt": float(fvd_recon),
        "fvd_same_split_floor": float(fvd_floor),
        "fvd_gen_over_floor": float(fvd_gen / max(fvd_floor, 1e-12)),
        "gen_psnr_vs_gt": float(10 * np.log10(1.0 / max(mse, 1e-12))),
        "extractor": provenance, "feature_dim": feature_dim,
        # the port's addition, as in training.e2e.log_fvd
        "fvd_regularized": [name for name, reg in (
            ("fvd_gen_vs_gt", reg_gen), ("fvd_recon_vs_gt", reg_recon),
            ("fvd_same_split_floor", reg_floor)) if reg],
        "time": time.time(),
    }
    out = args.out or os.path.join(args.run, "e2e_metrics.json")
    with open(out, "a") as fp:
        fp.write(json.dumps(record) + "\n")
    print("METRIC", json.dumps(record))
    return record


if __name__ == "__main__":
    main()
