"""Speed-control evaluation of a trained Single Moving MNIST run.

Port of the root ``eval_speed_control.py``. The reference conditions
generation on a scalar speed: the data's temporal subsampling interval
(reference dataload.py:246-258) and ``speed * speed_embedding`` added to the
anchor (reference mage_model.py:611-613,652-658). This measures whether a
trained model's generations follow the requested speed:

- the same first frame and caption at every speed of ``--speeds``, in one
  batched cached generate;
- the PSNR of each generation against the speed-matched ground-truth
  subsampling and against every mismatched one (diagonal dominance means
  control), beside the ground truth's own cross-speed PSNR and the VQ
  reconstruction ceiling;
- the digit's thresholded centroid track: per-frame displacement of the
  generations against the ground truth at each speed, and the track error.

It runs from a ``cli.train_mnist_e2e`` run's checkpoints (``vqvae/best``,
``mage/<--ckpt>``) and writes ``<run>/speed_control_metrics.json`` and
per-speed GIF strips. Every flag this parser does not know goes to
``train_mnist_e2e``'s parser (the run's ``--num-train``, ``--tiny``, ...).
``--device`` (default ``cuda``) is resolved before any data is built.

    python -m mage_tpu_torch.cli.eval_speed_control --run runs/mnist_e2e --videos 16
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from mage_tpu_torch.training.e2e import mse_to_psnr


def centroid_track(video: torch.Tensor, thresh: float = 0.15) -> torch.Tensor:
    """Per-frame digit centroid (px) of a (B, T, H, W, 1) clip in [-0.5, 0.5]
    -> (B, T, 2). The weights are thresholded intensities: generated
    backgrounds carry small positive decode noise over ~4k pixels, which
    unthresholded drags the centroid toward the frame centre and fakes a
    slow digit."""
    w = torch.clamp(video[..., 0] + 0.5 - thresh, min=0.0)  # (B, T, H, W)
    tot = torch.sum(w, dim=(-1, -2)) + 1e-6
    ys = torch.arange(video.shape[2], dtype=torch.float32, device=video.device)
    xs = torch.arange(video.shape[3], dtype=torch.float32, device=video.device)
    cy = torch.sum(w * ys[:, None], dim=(-1, -2)) / tot
    cx = torch.sum(w * xs[None, :], dim=(-1, -2)) / tot
    return torch.stack([cy, cx], dim=-1)


def masked_speed(track: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Mean per-frame centroid displacement over the valid prefix: track
    (B, T, 2), valid (T-1,) marks differences between real frames (high
    speeds pad by repeating the last picked frame, whose zero differences
    would deflate the mean)."""
    d = torch.sqrt(torch.sum(torch.diff(track, dim=1) ** 2, dim=-1))  # (B, T-1)
    return torch.sum(d * valid, dim=1) / torch.clamp(valid.sum(), min=1.0)


def parse_args(argv=None):
    """-> (this CLI's arguments, ``train_mnist_e2e``'s arguments for the run)."""
    from mage_tpu_torch.cli import train_mnist_e2e

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--run", default="runs/mnist_e2e_full")
    p.add_argument("--videos", type=int, default=16)
    p.add_argument("--speeds", type=float, nargs="+", default=[0.05, 0.275, 0.5, 0.725, 0.95])
    p.add_argument("--ckpt", default="final", help="mage checkpoint name")
    p.add_argument("--gifs", type=int, default=2, help="clips to write as per-speed GIF strips")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cpu runs the kernels' plain versions")
    args, rest = p.parse_known_args(argv)
    targs = train_mnist_e2e.parse_args(["--out", args.run, "--device", args.device, *rest])
    return args, targs


@torch.no_grad()
def sweep(targs, pipeline, model, bank, val: dict, speeds, g: int) -> dict:
    """The speed sweep on the first ``g`` val clips -> the tensors of the
    report (on the device): ``video`` and ``gt`` (S, g, L-1, 64, 64, 1),
    ``mat``, ``gt_cross``, ``pos_err`` (S, S), ``per_frame_matched``
    (S, L-1), ``ceiling``, ``sp_gen``, ``sp_gt`` (S,)."""
    from mage_tpu_torch.data import device_data as dd

    device = pipeline.device
    n_speeds, length = len(speeds), targs.frames_length
    digit, ys, xs, text = val["digit"][:g], val["ys"][:g], val["xs"][:g], val["text"][:g]
    # frame 0 of every clip (pos[0] == 0 at every speed)
    lat0 = model.encode(dd.compose_frames(bank, digit, ys[:, 0], xs[:, 0])).to(torch.int32)
    speed_t = torch.as_tensor(speeds, dtype=torch.float32, device=device).repeat_interleave(g)
    gen = pipeline.core.generate_cached(
        lat0[:, None].repeat(n_speeds, 1, 1, 1), text.repeat(n_speeds, 1), speed_t,
        generator=torch.Generator(device=device).manual_seed(7))
    video = pipeline.first_stage.decode(gen).reshape(n_speeds, g, length - 1, 64, 64, 1)

    positions = [dd.clip_indices(torch.tensor(s, device=device), frames_length=length).long()
                 for s in speeds]
    rows = torch.arange(g, device=device).repeat_interleave(length)
    gt = torch.stack([dd.compose_frames(bank, digit.repeat_interleave(length),
                                        ys[rows, pos.repeat(g)], xs[rows, pos.repeat(g)])
                      .reshape(g, length, 64, 64, 1) for pos in positions])[:, :, 1:]
    flat = gt.reshape(-1, 64, 64, 1)
    rec = model.decode(model.encode(flat)).reshape(gt.shape)

    def psnr(a, b, dim=None):
        return mse_to_psnr(torch.mean((a - b) ** 2) if dim is None
                           else torch.mean((a - b) ** 2, dim=dim))

    s_range = range(n_speeds)
    tr_gen = torch.stack([centroid_track(video[i]) for i in s_range])
    tr_gt = torch.stack([centroid_track(gt[i]) for i in s_range])
    valids = torch.stack([(torch.diff(pos[1:]) != 0).to(torch.float32) for pos in positions])
    return {
        "video": video, "gt": gt,
        # generation at speed i against the ground truth at speed j
        "mat": torch.stack([torch.stack([psnr(video[i], gt[j]) for j in s_range])
                            for i in s_range]),
        # the ground truth's own cross-speed similarity: the scale against
        # which diagonal dominance is judged
        "gt_cross": torch.stack([torch.stack([psnr(gt[i], gt[j]) for j in s_range])
                                 for i in s_range]),
        "per_frame_matched": torch.stack([psnr(video[i], gt[i], dim=(0, 2, 3, 4))
                                          for i in s_range]),
        "ceiling": torch.stack([psnr(rec[i], gt[i]) for i in s_range]),
        "sp_gen": torch.stack([torch.mean(masked_speed(tr_gen[i], valids[i]))
                               for i in s_range]),
        "sp_gt": torch.stack([torch.mean(masked_speed(tr_gt[i], valids[i])) for i in s_range]),
        "pos_err": torch.stack([torch.stack([
            torch.mean(torch.sqrt(torch.sum((tr_gen[i] - tr_gt[j]) ** 2, -1)))
            for j in s_range]) for i in s_range]),
    }


def report(out: dict, run: str, speeds, g: int) -> dict:
    """The JSON report of ``sweep``'s numbers (host floats, JAX's keys)."""
    mat, pos_err = out["mat"], out["pos_err"]
    n_speeds = len(speeds)
    diag = np.diag(mat)
    off = (mat.sum(1) - diag) / (n_speeds - 1)
    pdiag = np.diag(pos_err)
    return {
        "run": run, "videos": g, "speeds": list(speeds),
        "psnr_matrix_gen_x_gt": np.round(mat, 3).tolist(),
        "psnr_matched": np.round(diag, 3).tolist(),
        "psnr_mismatched_mean": np.round(off, 3).tolist(),
        "recon_ceiling_matched": np.round(out["ceiling"], 3).tolist(),
        "gt_cross_speed_psnr": np.round(out["gt_cross"], 3).tolist(),
        "per_frame_psnr_matched": np.round(out["per_frame_matched"], 2).tolist(),
        "pos_err_px_gen_x_gt": np.round(pos_err, 3).tolist(),
        "pos_err_matched": np.round(pdiag, 3).tolist(),
        "centroid_px_per_frame_gen": np.round(out["sp_gen"], 3).tolist(),
        "centroid_px_per_frame_gt": np.round(out["sp_gt"], 3).tolist(),
        "psnr_diagonal_dominant": bool((diag >= mat.max(1) - 1e-6).all()),
        "pos_err_diagonal_dominant": bool((pdiag <= pos_err.min(1) + 1e-6).all()),
        "gen_speed_monotonic": bool(np.all(np.diff(out["sp_gen"]) > 0)),
        "gen_gt_rate_correlation": float(np.corrcoef(out["sp_gen"], out["sp_gt"])[0, 1]),
    }


def main(argv=None):
    from mage_tpu_torch.cli.eval_fvd_e2e import restore_run
    from mage_tpu_torch.models.pipeline import resolve_device
    from mage_tpu_torch.utils.media import save_gif

    args, targs = parse_args(argv)
    device = resolve_device(args.device)
    dev, model, pipeline = restore_run(targs, device, args.ckpt)
    g = min(args.videos, int(dev["val"]["digit"].shape[0]))

    out = sweep(targs, pipeline, model, dev["bank"], dev["val"], args.speeds, g)
    out = {k: v.float().cpu().numpy() for k, v in out.items()}
    rec = report(out, args.run, args.speeds, g)
    path = os.path.join(args.run, "speed_control_metrics.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec, indent=1))

    gif_dir = os.path.join(args.run, "gifs")
    os.makedirs(gif_dir, exist_ok=True)
    video, gt = out["video"], out["gt"]
    for i in range(min(args.gifs, g)):
        # rows top to bottom: increasing speed; left GT, right generated
        strip = np.concatenate([np.concatenate([gt[s, i], video[s, i]], axis=2)
                                for s in range(len(args.speeds))], axis=1)
        save_gif(strip, os.path.join(gif_dir, f"speed_sweep_{i}.gif"))
    print(f"wrote {path} and {min(args.gifs, g)} sweep gifs")
    return rec


if __name__ == "__main__":
    main()
