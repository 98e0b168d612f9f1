"""Reconstruction bound of a CATER run's VQ-VAE, measured two ways.

Port of ``scripts/diag_recon_bound.py``, which looks for the gap between
stage 1's val reconstruction PSNR and the generation eval's
``recon_psnr_vs_gt_upper_bound``. On the val clips and positions the eval
uses it measures

  (a) stage-1-style reconstruction: frames 0, 12 and 23 of the first ``G``
      val clips, encoded and decoded;
  (b) eval-style reconstruction: the ids of every stored frame of each clip
      (one encode per clip), decoded at the speed-1.0 positions of a
      10-frame clip and compared with the composed ground truth, over
      frames 1..9 and per position.

If (a) and (b) differ on the same checkpoint, the gap lies in the position
sampling or the indexing; if both are low, stage 1's own val metric is the
odd one out.

The data are the tool's own: 8 + 8 procedural CATER-GEN-v2 scenes from seed
0. The VQ-VAE is ``<run>/vqvae/best``; every flag this parser does not know
goes to ``train_cater_e2e``'s parser (the run's ``--dim``, ``--codebook``,
``--tiny``). The report goes to ``<run>/diag_recon_bound.json``, or to
``--report``. ``--device`` (default ``cuda``) is resolved before any data is
built.

    python -m mage_tpu_torch.cli.diag_recon_bound --run runs/cater_e2e
"""

from __future__ import annotations

import argparse
import os

import torch

from mage_tpu_torch.cli import train_cater_e2e as tc

T_STORE = tc.T_STORE  # 24 stored frames per clip
G = 8  # val clips (the whole val split)
LENGTH = 10  # the eval's clip length
STAGE1_FRAMES = (0, 12, 23)


def parse_args(argv=None):
    """-> (this CLI's arguments, ``train_cater_e2e``'s arguments for the run)."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--run", default="runs/cater_e2e")
    p.add_argument("--report", default=None,
                   help="default: <run>/diag_recon_bound.json")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cpu runs the kernels' plain versions")
    args, rest = p.parse_known_args(argv)
    a = tc.parse_args(["--out", args.run, "--device", args.device, *rest])
    return args, a


def load_vqvae(a, device):
    """The run's VQ-VAE from ``<run>/vqvae/best``, in eval mode."""
    from mage_tpu_torch.training.checkpoint import Checkpointer

    model = tc.make_vqvae(a, device)
    model.load_state_dict(Checkpointer(os.path.join(a.out, "vqvae")).restore(
        "best", device)["state_dict"])
    return model.eval()


def eval_positions(g: int, device) -> torch.Tensor:
    """The eval's stored-frame positions at speed 1.0 -> (g, LENGTH) int32."""
    return tc.clip_positions(torch.full((g,), 1.0, dtype=torch.float32, device=device),
                             LENGTH)


@torch.no_grad()
def stage1_style(model, frames_at, g: int) -> list:
    """(a): [(frame, MSE)] of each of ``STAGE1_FRAMES`` over the first ``g``
    clips, encoded and decoded."""
    device = model.codebook.embedding.weight.device
    idx = torch.arange(g, device=device)
    rows = []
    for f in STAGE1_FRAMES:
        frames = frames_at(idx, torch.full((g,), f, dtype=torch.long, device=device))
        rec = model.decode(model.encode(frames))
        rows.append((f, float(torch.mean((rec - frames) ** 2))))
    return rows


@torch.no_grad()
def eval_style(model, frames_at, g: int):
    """(b): -> (positions (g, LENGTH), the MSE over frames 1.., the MSE per
    position (LENGTH,)), the last two f32 tensors."""
    device = model.codebook.embedding.weight.device
    t_all = torch.arange(T_STORE, device=device)
    ids_all = torch.stack([
        model.encode(frames_at(torch.full((T_STORE,), i, dtype=torch.long, device=device),
                               t_all))
        for i in range(g)])  # (g, T_STORE, h, w)
    pos = eval_positions(g, device).long()
    clips = torch.arange(g, device=device)
    gt = frames_at(clips.repeat_interleave(LENGTH), pos.reshape(-1))
    gt = gt.reshape(g, LENGTH, *gt.shape[1:])
    sel = ids_all[clips[:, None], pos]
    rec = model.decode(sel.reshape(-1, *sel.shape[2:])).reshape(gt.shape)
    mse_all = torch.mean((rec[:, 1:] - gt[:, 1:]) ** 2)
    return pos, mse_all, torch.mean((rec - gt) ** 2, dim=(0, 2, 3, 4))


def report(run: str, g: int, stage1: list, pos, mse_all, per_position) -> dict:
    psnr = tc.mse_to_psnr  # pixels in [-1, 1]: 10 log10(4 / mse)
    return {
        "phase": "diag_recon_bound", "run": run, "videos": g,
        "stage1": [{"frame": f, "mse": m, "psnr": psnr(m)} for f, m in stage1],
        "positions": pos[0].tolist(),
        "eval_mse": float(mse_all), "eval_psnr": psnr(float(mse_all)),
        "per_position": [{"pos": int(p), "mse": float(m), "psnr": psnr(float(m))}
                         for p, m in zip(pos[0].tolist(), per_position.tolist())],
    }


def main(argv=None):
    from mage_tpu_torch.data.generators import cater_synthetic as cs
    from mage_tpu_torch.models.pipeline import resolve_device
    from mage_tpu_torch.training import e2e

    args, a = parse_args(argv)
    device = resolve_device(args.device)
    dev = tc.upload(cs.build_compact_cater(8, G, 0, dataset="CATER-GEN-v2",
                                           context_length=38), device)
    model = load_vqvae(a, device)

    def frames_at(idx, t):
        return tc.frames_at(dev, "val", idx, t)

    stage1 = stage1_style(model, frames_at, G)
    pos, mse_all, per_position = eval_style(model, frames_at, G)
    rec = report(args.run, G, stage1, pos, mse_all, per_position)
    for row in rec["stage1"]:
        print(f"(a) frame {row['frame']:2d}: mse {row['mse']:.6f} psnr {row['psnr']:.2f} dB")
    print("positions:", rec["positions"])
    print(f"(b) eval-style recon: mse {rec['eval_mse']:.6f} psnr {rec['eval_psnr']:.2f} dB")
    for row in rec["per_position"]:
        print(f"    pos {row['pos']:2d}: mse {row['mse']:.6f} psnr {row['psnr']:.2f} dB")
    e2e.write_report(rec, args.run, "diag_recon_bound", args.report)
    return rec


if __name__ == "__main__":
    main()
