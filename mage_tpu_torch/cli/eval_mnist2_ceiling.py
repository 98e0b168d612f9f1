"""Reconstruction ceilings of a Modified-Double-MNIST stage-1 checkpoint.

Port of ``scripts/eval_mnist2_ceiling.py``. A stage-1 VQ-VAE bounds every
stage-2 metric of its chain; this measures those bounds for any stage-1 run
without touching stage 2, so two stage-1 arms can be compared at stage-1
cost:

- ``recon_ceiling_stage1``: val reconstruction MSE and PSNR at frame 0 and
  at a mid-motion frame, the mean SSIM of the first 32 frame-0
  reconstructions, and codebook occupancy (distinct ids) at both frames;
- ``recon_ceiling_tracking``: on the first ``--videos`` val clips
  subsampled at speed 0.5, the two captioned digits template-tracked
  through first-stage reconstructions of the ground truth (direction
  accuracy, track error, motion correctness): the upper bounds the
  generation eval of ``cli.train_mnist2_e2e`` reports beside its own.

Both records are appended to ``<run>/e2e_metrics.json``. The VQ-VAE is
``<run>/vqvae/<--ckpt>``; ``--seed``, ``--num-train`` and ``--num-val`` must
be the run's (the procedural split), ``--dim`` and ``--codebook`` its
widths. ``--device`` (default ``cuda``) is resolved before any data is
built.

    python -m mage_tpu_torch.cli.eval_mnist2_ceiling --run runs/mnist2_cb \\
        --num-train 8000 --num-val 2000
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from mage_tpu_torch.cli import train_mnist2_e2e as m2

T_STORED = m2.T_STORED
ENCODE_CHUNK = 512  # frames per encode and decode call of the tracking clips


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--run", required=True,
                   help="run dir holding vqvae/<ckpt> from train_mnist2_e2e")
    p.add_argument("--ckpt", default="best")
    p.add_argument("--seed", type=int, default=0,
                   help="must match the training run's --seed (dataset RNG)")
    p.add_argument("--num-train", type=int, default=24000)
    p.add_argument("--num-val", type=int, default=6000)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--codebook", type=int, default=512)
    p.add_argument("--mnist-npz", default=None)
    p.add_argument("--videos", type=int, default=64,
                   help="val clips for the tracking-ceiling section")
    p.add_argument("--frames-length", type=int, default=16)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cpu runs the kernels' plain versions")
    return p.parse_args(argv)


@torch.no_grad()
def stage1_recon(model, dev: dict, b: int, frame: int):
    """Frame ``frame`` of the first ``b`` val clips through encode and
    decode -> (MSE, distinct ids, frames, reconstructions)."""
    device = dev["bank"].device
    frames = m2.frames_at(dev, "val", torch.arange(b, device=device),
                          torch.full((b,), frame, dtype=torch.long, device=device))
    ids = model.encode(frames)
    recon = model.decode(ids)
    return torch.mean((recon - frames) ** 2), torch.unique(ids).numel(), frames, recon


@torch.no_grad()
def recon_clips(model, dev: dict, pos: torch.Tensor):
    """The first ``len(pos)`` val clips at ``pos`` (g, L) -> (their
    reconstructions and ground truth (g, L, 64, 64, 1), the MSE over frames
    1..L-1), through encode and decode in chunks of ``ENCODE_CHUNK`` frames."""
    g, length = pos.shape
    clips = torch.arange(g, device=pos.device)
    gt = m2.frames_at(dev, "val", clips.repeat_interleave(length), pos.reshape(-1))
    ids = torch.cat([model.encode(c) for c in gt.split(ENCODE_CHUNK)])
    rec = torch.cat([model.decode(c) for c in ids.split(ENCODE_CHUNK)])
    rec, gt = rec.reshape(g, length, *rec.shape[1:]), gt.reshape(g, length, *gt.shape[1:])
    return rec, gt, torch.mean((rec[:, 1:] - gt[:, 1:]) ** 2)


def main(argv=None):
    from mage_tpu_torch.cli import train_mnist_e2e as single
    from mage_tpu_torch.data import device_data as dd
    from mage_tpu_torch.evals.metrics import ssim as np_ssim
    from mage_tpu_torch.models.pipeline import resolve_device
    from mage_tpu_torch.training.checkpoint import Checkpointer

    args = parse_args(argv)
    device = resolve_device(args.device)
    print(f"device: {device}")
    compact = dd.build_compact_double_modified(args.num_train, args.num_val, args.seed,
                                               args.mnist_npz)
    dev = single.upload(compact, device)
    model = single.make_vqvae(args, device)
    model.load_state_dict(Checkpointer(os.path.join(args.run, "vqvae")).restore(
        args.ckpt, device)["state_dict"])
    model.eval()

    # stage-1-style recon metrics (frame 0 and a mid-motion frame)
    n_val = int(dev["val"]["d1"].shape[0])
    eval_b = min(512, n_val)
    mse0, used0, frames, recon = stage1_recon(model, dev, eval_b, 0)
    mse_m, used_m, _, _ = stage1_recon(model, dev, eval_b, T_STORED // 2)
    f_np = frames[:32, ..., 0].float().cpu().numpy()
    r_np = recon[:32, ..., 0].float().cpu().numpy()
    stage1 = {
        "phase": "recon_ceiling_stage1", "run": args.run, "ckpt": args.ckpt,
        "val_recon_mse": float(mse0), "val_recon_psnr": m2.mse_to_psnr(float(mse0)),
        "val_recon_psnr_motion": m2.mse_to_psnr(float(mse_m)),
        "val_ssim": float(np.mean([np_ssim(a, b, data_range=1.0)
                                   for a, b in zip(f_np, r_np)])),
        "codebook_used": used0, "codebook_used_motion": used_m,
    }
    m2.log_metrics(args.run, stage1)

    # eval-style tracking ceilings on reconstructions
    g = min(args.videos, n_val)
    d = dev["val"]
    speed = torch.full((g,), 0.5, dtype=torch.float32, device=device)
    pos = dd.clip_indices_var(speed, d["length"][:g], args.frames_length).long()
    recs, _, mse_recon = recon_clips(model, dev, pos)
    dev_host = {k: v.cpu().numpy() for k, v in d.items() if k != "text"}
    ceil = m2.motion_metrics(recs[:, 1:, ..., 0].float().cpu().numpy(), dev_host,
                             dev["bank"].cpu().numpy(), np.arange(g), pos.cpu().numpy())
    tracking = {
        "phase": "recon_ceiling_tracking", "samples": g,
        "recon_psnr_vs_gt_upper_bound": m2.mse_to_psnr(float(mse_recon)),
        "recon_motion_correct_ceiling": ceil["motion_correct_frac"],
        "recon_track_error_px_ceiling": ceil["mean_track_error_px"],
        "recon_direction_acc_ceiling": ceil["initial_direction_acc"],
        "direction_cases": ceil["direction_cases"],
    }
    m2.log_metrics(args.run, tracking)
    return stage1, tracking


if __name__ == "__main__":
    main()
