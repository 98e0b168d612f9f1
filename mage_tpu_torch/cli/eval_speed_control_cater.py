"""Speed-control evaluation of a trained CATER run.

Port of the root ``eval_speed_control_cater.py``, the CATER twin of
``eval_speed_control`` on dataset-agnostic signals only:

- **PSNR speed matrix**: the same first frame and caption at every speed
  of ``--speeds``, in one batched cached generate; the PSNR of each
  generation against the speed-matched ground-truth subsampling and every
  mismatched one (diagonal dominance: the model follows the requested
  speed, not a default pace);
- **motion-energy rate**: the mean per-frame pixel change of generation
  and ground truth at each speed (CATER scenes translate rigid sprites, so
  frame-difference energy rises with playback speed), their correlation
  and monotonicity across speeds.

It runs from a ``cli.train_cater_e2e`` run's best checkpoints and appends
its record to ``<run>/e2e_metrics.json``, with GIFs under ``<run>/gifs``.
The dataset arguments (``--dataset``, ``--num-train``, ``--num-val``,
``--seed``) must be the run's, so the procedural val split is the run's;
every flag this parser does not know goes to ``train_cater_e2e``'s parser
(the run's ``--tiny``, ``--dim``, ...). ``--device`` (default ``cuda``) is
resolved before any data is built.

    python -m mage_tpu_torch.cli.eval_speed_control_cater --run runs/cater_e2e --videos 12
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def parse_args(argv=None):
    """-> (this CLI's arguments, ``train_cater_e2e``'s arguments for the run)."""
    from mage_tpu_torch.cli import train_cater_e2e as tc

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--run", default="runs/cater_e2e")
    p.add_argument("--videos", type=int, default=12)
    p.add_argument("--speeds", type=float, nargs="+", default=[0.0, 0.5, 1.0])
    p.add_argument("--dataset", default="caterv2", choices=["caterv1", "caterv2"])
    p.add_argument("--num-train", type=int, default=3000)
    p.add_argument("--num-val", type=int, default=600)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--gifs", type=int, default=2)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cpu runs the kernels' plain versions")
    args, rest = p.parse_known_args(argv)
    a = tc.parse_args(["--out", args.run, "--dataset", args.dataset, "--num-train",
                       str(args.num_train), "--num-val", str(args.num_val), "--seed",
                       str(args.seed), "--device", args.device, *rest])
    if a.config is None:
        a.config = f"config/mage_{a.dataset}.yaml"
    return args, a


def load_run(a, device):
    """The run's procedural dataset on ``device`` and both stages' best
    checkpoints, as ``train_cater_e2e``'s eval-only path restores them ->
    (dev, vqvae, pipeline)."""
    from mage_tpu_torch.cli import train_cater_e2e as tc
    from mage_tpu_torch.training.checkpoint import Checkpointer

    dev = tc.upload(tc.build_dataset(a), device)
    model = tc.make_vqvae(a, device)
    model.load_state_dict(Checkpointer(os.path.join(a.out, "vqvae")).restore(
        "best", device)["state_dict"])
    model.eval()
    pipeline = tc.build_pipeline(a, model, device)
    pipeline.core.load_state_dict(Checkpointer(os.path.join(a.out, "mage")).restore(
        "best", device)["model"])
    return dev, model, pipeline


@torch.no_grad()
def sweep(a, pipeline, model, dev, speeds, g: int):
    """The speed sweep on the first ``g`` val scenes -> (mse (S_gen, S_gt,
    g), gen_rate (S,), gt_rate (S,), video and gt (S, g, L-1, 128, 128, 3)),
    on the device."""
    from mage_tpu_torch.cli import train_cater_e2e as tc

    device = pipeline.device
    n_speeds, length = len(speeds), a.frames_length
    scenes = torch.arange(g, device=device)
    # shared first frame: clip_positions(s)[0] == 0 at every speed
    f0 = tc.frames_at(dev, "val", scenes, torch.zeros((g,), dtype=torch.long, device=device))
    lat0 = model.encode(f0).to(torch.int32)[:, None]
    speed_t = torch.as_tensor(speeds, dtype=torch.float32, device=device)
    # speed-major flat batch: block i holds all g scenes at speeds[i]
    gen = pipeline.core.generate_cached(
        lat0.repeat(n_speeds, 1, 1, 1), dev["val"]["text"][:g].repeat(n_speeds, 1),
        speed_t.repeat_interleave(g), generator=torch.Generator(device=device).manual_seed(7))
    video = pipeline.first_stage.decode(gen, max_chunk=128)
    video = video.reshape(n_speeds, g, length - 1, *video.shape[2:])
    gt = torch.stack([tc.gt_clips(dev, "val", g, tc.clip_positions(speed_t[i], length)
                                  .long().expand(g, length))[:, 1:]
                      for i in range(n_speeds)])
    mse = torch.mean((video[:, None] - gt[None, :]) ** 2, dim=(3, 4, 5, 6))
    gen_rate = torch.mean(torch.abs(torch.diff(video, dim=2)), dim=(1, 2, 3, 4, 5))
    gt_rate = torch.mean(torch.abs(torch.diff(gt, dim=2)), dim=(1, 2, 3, 4, 5))
    return mse, gen_rate, gt_rate, video, gt


def record(mse: np.ndarray, gen_rate: np.ndarray, gt_rate: np.ndarray, speeds,
           g: int) -> dict:
    """The ``speed_control`` record (JAX's keys) of ``sweep``'s host
    arrays: elementwise PSNR over [-1, 1] pixels (range 2)."""
    n_speeds = len(speeds)
    psnr = 10.0 * np.log10(4.0 / np.maximum(np.asarray(mse, np.float64), 1e-12))
    mat = psnr.mean(axis=-1)  # (S_gen, S_gt)
    per_scene_match = psnr.argmax(axis=1) == np.arange(n_speeds)[:, None]
    diag_margin = [float(mat[i, i] - np.delete(mat[i], i).max()) for i in range(n_speeds)]
    rate_corr = float(np.corrcoef(gen_rate, gt_rate)[0, 1]) if n_speeds > 1 else 1.0
    return {
        "phase": "speed_control", "videos": g,
        "speeds": [float(s) for s in speeds],
        "psnr_matrix": [[round(float(v), 3) for v in row] for row in mat],
        "psnr_diagonal_dominant": bool((mat.argmax(axis=1) == np.arange(n_speeds)).all()),
        "diag_margin_db": [round(m, 3) for m in diag_margin],
        "per_scene_matched_frac": float(per_scene_match.mean()),
        "gen_motion_rate": [round(float(v), 5) for v in gen_rate],
        "gt_motion_rate": [round(float(v), 5) for v in gt_rate],
        "gen_gt_rate_correlation": round(rate_corr, 4),
        "gen_rate_monotonic": bool(np.all(np.diff(gen_rate) > 0)),
    }


def main(argv=None):
    from mage_tpu_torch.cli import train_cater_e2e as tc
    from mage_tpu_torch.models.pipeline import resolve_device
    from mage_tpu_torch.utils.media import save_gif

    args, a = parse_args(argv)
    device = resolve_device(args.device)
    dev, model, pipeline = load_run(a, device)
    g = min(args.videos, int(dev["val"]["sid"].shape[0]))
    mse, gen_rate, gt_rate, video, gt = sweep(a, pipeline, model, dev, args.speeds, g)
    rec = record(*(t.float().cpu().numpy() for t in (mse, gen_rate, gt_rate)),
                 args.speeds, g)
    tc.log_metrics(args.run, rec)
    os.makedirs(os.path.join(args.run, "gifs"), exist_ok=True)
    vid_gif = video[:, :args.gifs].float().cpu().numpy()
    gt_gif = gt[:, :args.gifs].float().cpu().numpy()
    for k in range(min(args.gifs, g)):
        # rows: speeds; columns: GT | generated
        side = np.concatenate([gt_gif[:, k], vid_gif[:, k]], axis=3)
        save_gif(np.concatenate(list(side), axis=1),
                 os.path.join(args.run, "gifs", f"speed_control_{k}.gif"))
    print({k: v for k, v in rec.items() if k != "phase"})
    return rec


if __name__ == "__main__":
    main()
