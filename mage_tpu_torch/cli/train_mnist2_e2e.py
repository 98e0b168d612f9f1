"""End-to-end Modified Double Moving MNIST training on one GPU.

Port of the root ``train_mnist2_e2e.py``: two digits with per-digit
stop-at-wall or bounce physics, two-clause captions and a random static
distractor digit. The chain is ``train_mnist_e2e``'s (resident data, the
f4 VQ-VAE, materialized ids, MAGE), and the generation eval adds per-digit
motion correctness: each captioned digit is template-tracked through the
generated video against its ground-truth trajectory, beside the same
tracking on first-stage reconstructions (the tracker's ceiling) and FVD.

    python -m mage_tpu_torch.cli.train_mnist2_e2e --out runs/mnist2_e2e --bf16
    python -m mage_tpu_torch.cli.train_mnist2_e2e --tiny --device cpu --out /tmp/e2e2
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from mage_tpu_torch.cli import train_mnist_e2e as single
from mage_tpu_torch.data import device_data as dd
from mage_tpu_torch.training import e2e

T_STORED = dd.SEQ_LENGTH + 1  # 21 stored frames (edge-padded tracks)
log_metrics = e2e.log_metrics
mse_to_psnr = e2e.mse_to_psnr
TINY = dict(num_train=64, num_val=16, dim=16, codebook=32, stage1_epochs=2,
            stage2_epochs=2, batch1=8, batch2=4, chunk=2, eval_videos=4, gifs=1)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="runs/mnist2_e2e")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mnist-npz", default=None)
    p.add_argument("--num-train", type=int, default=24000)
    p.add_argument("--num-val", type=int, default=6000)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--codebook", type=int, default=512)
    p.add_argument("--stage1-epochs", type=int, default=100)
    p.add_argument("--batch1", type=int, default=128)
    p.add_argument("--lr1", type=float, default=1e-4)
    p.add_argument("--beta1", type=float, default=2.0)
    p.add_argument("--config", default="config/mage_mnist.yaml")
    p.add_argument("--stage2-epochs", type=int, default=60)
    p.add_argument("--batch2", type=int, default=16)
    p.add_argument("--lr2", type=float, default=5e-5)
    p.add_argument("--frames-length", type=int, default=16)
    p.add_argument("--chunk", type=int, default=50)
    p.add_argument("--skip-stage1", action="store_true")
    p.add_argument("--skip-stage2", action="store_true")
    p.add_argument("--eval-only", action="store_true",
                   help="restore <out>/{vqvae,mage}/<--eval-ckpt> and run "
                        "the generation evals only")
    p.add_argument("--resume", action="store_true",
                   help="legacy: warm-restart stage 2 from a weights-only "
                        "'final' checkpoint at --resume-epoch (stage 2 "
                        "resumes from <out>/mage/last by itself when it exists)")
    p.add_argument("--resume-epoch", type=int, default=0,
                   help="with --resume when only a weights-only 'final' "
                        "checkpoint exists: the epoch that run had reached")
    p.add_argument("--eval-ckpt", default="final")
    p.add_argument("--eval-videos", type=int, default=64)
    p.add_argument("--gifs", type=int, default=6)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--motion-loss-weight", type=float, default=0.0,
                   help="opt-in motion-weighted recon loss (MAGECore."
                        "motion_loss_weight): upweights tokens whose ids "
                        "change between frames (0 = reference-exact)")
    p.add_argument("--early-loss-weight", type=float, default=0.0,
                   help="opt-in early-frame loss upweighting "
                        "(MAGECore.early_loss_weight; 0 = reference-exact)")
    p.add_argument("--early-loss-frames", type=int, default=3)
    p.add_argument("--codebook-restart", action="store_true",
                   help="re-seed dead codebook entries every other epoch "
                        "from encoder features (off = reference parity)")
    p.add_argument("--tiny", action="store_true",
                   help="smoke-test scale: shrinks only the flags left at their defaults "
                        "(JAX's train_mnist2_e2e.py --tiny overrides every explicit flag but "
                        "--stage2-epochs)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cpu runs the kernels' plain versions")
    e2e.add_fvd_extractor_args(p)
    return p


def parse_args(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    if args.tiny:
        e2e.apply_tiny(args, p, TINY)
    return args


def frames_at(dev, split, idx, t):
    """Compose frames (len(idx),) x stored-frame t on the device."""
    d = dev[split]
    return dd.compose_frames_double(
        dev["bank"], d["d1"][idx], d["ys1"][idx, t], d["xs1"][idx, t],
        d["d2"][idx], d["ys2"][idx, t], d["xs2"][idx, t],
        d["bg"][idx], d["bg_y"][idx], d["bg_x"][idx], d["has_bg"][idx],
    )


def stage1(args, dev, model, out_dir):
    return e2e.run_vqvae_stage1(
        args, model,
        frames_at=lambda split, idx, t: frames_at(dev, split, idx, t),
        t_store=T_STORED,
        n_train=int(dev["train"]["d1"].shape[0]),
        n_val=int(dev["val"]["d1"].shape[0]),
        out_dir=out_dir,
        eval_cap=512,
        ssim_count=args.eval_videos,
        data_range=1.0,
    )


def materialize_latents(args, model, dev, split, device):
    """Encode all 21 stored frames of every clip -> ids (N, 21, h, w)."""
    n = int(dev[split]["d1"].shape[0])
    return e2e.materialize(n, 50, single.encode_clips(
        model, lambda idx, t: frames_at(dev, split, idx, t), T_STORED, device), device)


def batch_from(args, idx, speed, ids, text, length) -> dict:
    """The teacher-forced batch of clips ``idx`` at ``speed``, subsampled
    within each clip's own length."""
    pos = dd.clip_indices_var(speed, length[idx], args.frames_length).long()
    return {"latents": ids[idx[:, None], pos], "text": text[idx], "speed": speed}


def stage2(args, pipeline, dev, ids_train, ids_val, out_dir):
    n, n_val = int(ids_train.shape[0]), int(ids_val.shape[0])
    eval_b = min(64, n_val)
    len_train, len_val = dev["train"]["length"], dev["val"]["length"]

    def batch_at(gen, ids, text):
        return batch_from(args, *e2e.draw_clips(gen, n, args.batch2), ids, text, len_train)

    def val_batch_at(gen, ids, text):
        return batch_from(args, *e2e.draw_clips(gen, n_val, eval_b), ids, text, len_val), gen

    return e2e.run_mage_stage2(
        args, pipeline,
        batch_at=batch_at, val_batch_at=val_batch_at,
        lat_train=ids_train, lat_val=ids_val,
        text_train=dev["train"]["text"], text_val=dev["val"]["text"],
        out_dir=out_dir,
        last_every=5,  # this chain checkpoints the full state on every eval
        legacy_resume_epoch=args.resume_epoch if args.resume else None,
    )


# ---------------------------------------------------------------------------
# Evaluation: generation PSNR + per-digit motion correctness
# ---------------------------------------------------------------------------


def track_digit(video: np.ndarray, template: np.ndarray) -> np.ndarray:
    """Template-match one digit through a (L, 64, 64) video -> (L, 2) int
    (y, x) positions: zero-mean cross-correlation over all 37x37 valid
    placements (the exact digit instance is known, so matched filtering is
    reliable even beside a same-looking distractor)."""
    from numpy.lib.stride_tricks import sliding_window_view

    tm = template - template.mean()
    L = video.shape[0]
    pos = np.zeros((L, 2), np.int32)
    for t in range(L):
        wins = sliding_window_view(video[t], (dd.DIGIT_SIZE, dd.DIGIT_SIZE))
        score = np.einsum("yxhw,hw->yx", wins, tm, optimize=True)
        iy, ix = np.unravel_index(np.argmax(score), score.shape)
        pos[t] = (iy, ix)
    return pos


def motion_metrics(gen: np.ndarray, dev_host: dict, bank: np.ndarray,
                   idx: np.ndarray, pos_all: np.ndarray) -> dict:
    """Per-digit motion correctness of generated videos against the ground
    truth. ``gen``: (G, L-1, 64, 64) generated frames 1..L-1 in
    [-0.5, 0.5]. Each captioned digit is tracked through the video and
    compared with its trajectory at the same subsampled positions: mean
    per-frame position error (px), the fraction of tracks within 5 px
    ("motion correct"), and the initial direction's accuracy (the sign of
    the first displacement above 2 px)."""
    errs, correct, dir_ok, n_dir = [], 0, 0, 0
    for i in range(gen.shape[0]):
        ci = int(idx[i])
        pos = pos_all[i]  # (L,) stored-frame indices
        for dkey, ykey, xkey in (("d1", "ys1", "xs1"), ("d2", "ys2", "xs2")):
            tmpl = bank[dev_host[dkey][ci]]
            gt = np.stack([dev_host[ykey][ci, pos], dev_host[xkey][ci, pos]], -1)
            tr = track_digit(gen[i], tmpl)  # frames 1..L-1
            err = np.abs(tr - gt[1:]).mean()
            errs.append(err)
            correct += int(err <= 5.0)
            # initial direction along the GT-moving axis
            d_gt = gt[1:] - gt[0]
            first = np.argmax(np.abs(d_gt).max(1) > 2)  # first real move
            ax = int(np.abs(d_gt[first]).argmax())
            if abs(d_gt[first][ax]) > 2:
                n_dir += 1
                d_tr = tr[first] - gt[0]
                dir_ok += int(np.sign(d_tr[ax]) == np.sign(d_gt[first][ax]))
    n = len(errs)
    return {
        "digit_tracks": n,
        "mean_track_error_px": float(np.mean(errs)),
        "motion_correct_frac": correct / n,
        "initial_direction_acc": dir_ok / max(n_dir, 1),
        "direction_cases": n_dir,
    }


def to_rgb(v):
    """[-0.5, 0.5] grayscale -> [-1, 1] RGB (the I3D extractor's input)."""
    return np.repeat(2.0 * np.clip(v + 0.5, 0, 1) - 1.0, 3, axis=-1)


@torch.no_grad()
def eval_generation(args, pipeline, dev, ids, split, out_dir):
    device = pipeline.device
    d = dev[split]
    g = min(args.eval_videos, int(ids.shape[0]))
    text = d["text"][:g]
    speed = torch.full((g,), 0.5, dtype=torch.float32, device=device)
    pos = dd.clip_indices_var(speed, d["length"][:g], args.frames_length).long()
    ids_g = ids[:g]
    gen = pipeline.core.generate_cached(
        ids_g[:, :1], text, speed, generator=torch.Generator(device=device).manual_seed(7))
    video = pipeline.first_stage.decode(gen)
    length = pos.shape[1]
    arange = torch.arange(g, device=device)
    gt_flat = frames_at(dev, split, arange.repeat_interleave(length), pos.reshape(-1))
    gt = gt_flat.reshape(g, length, *gt_flat.shape[1:])
    recon_gt = pipeline.first_stage.decode(ids_g[arange[:, None], pos])
    mse_gen = float(torch.mean((video - gt[:, 1:]) ** 2))
    mse_recon = float(torch.mean((recon_gt[:, 1:] - gt[:, 1:]) ** 2))

    video_np = video.float().cpu().numpy()
    recon_np = recon_gt.float().cpu().numpy()
    gt_np = gt.float().cpu().numpy()
    dev_host = {k: v.cpu().numpy() for k, v in d.items() if k != "text"}
    bank_np = dev["bank"].cpu().numpy()
    pos_np = pos.cpu().numpy()
    mm = motion_metrics(video_np[..., 0], dev_host, bank_np, np.arange(g), pos_np)
    # tracking ceiling: the same metric on first-stage reconstructions of
    # the GT latents, which separates "the generator does not follow the
    # caption" from "the tracker cannot follow decoded pixels"
    mm_ceil = motion_metrics(recon_np[:, 1:, ..., 0], dev_host, bank_np, np.arange(g),
                             pos_np)
    log_metrics(out_dir, {
        "phase": f"generation_{split}", "samples": g,
        "gen_psnr_vs_gt": mse_to_psnr(mse_gen),
        "recon_psnr_vs_gt_upper_bound": mse_to_psnr(mse_recon),
        **mm,
        "recon_motion_correct_ceiling": mm_ceil["motion_correct_frac"],
        "recon_track_error_px_ceiling": mm_ceil["mean_track_error_px"],
        "recon_direction_acc_ceiling": mm_ceil["initial_direction_acc"],
    })
    e2e.log_fvd(out_dir, split, "MovingMNIST", to_rgb(gt_np[:, 1:]), to_rgb(video_np),
                to_rgb(recon_np[:, 1:]), batch_size=8, device=device,
                i3d_checkpoint=args.i3d_checkpoint, extractor_dir=args.fvd_extractor)
    e2e.write_side_gifs(out_dir, split, gt_np, video_np, args.gifs, scale=2.0)
    return mse_gen


def main(argv=None):
    from mage_tpu_torch.models.pipeline import resolve_device
    from mage_tpu_torch.training.checkpoint import Checkpointer

    args = parse_args(argv)
    device = resolve_device(args.device)
    torch.manual_seed(args.seed)
    os.makedirs(args.out, exist_ok=True)
    print(f"device: {device}")

    compact = dd.build_compact_double_modified(args.num_train, args.num_val, args.seed,
                                               args.mnist_npz)
    dev = single.upload(compact, device)
    print(f"resident dataset: {compact['bank'].nbytes / 1e6:.1f} MB bank, "
          f"{args.num_train} train / {args.num_val} val clips")

    model = single.make_vqvae(args, device)
    if args.skip_stage1 or args.eval_only:
        best = Checkpointer(os.path.join(args.out, "vqvae")).restore("best", device)
        model.load_state_dict(best["state_dict"])
    else:
        stage1(args, dev, model, args.out)
    if args.skip_stage2 and not args.eval_only:
        return
    t0 = time.time()
    ids_train = materialize_latents(args, model, dev, "train", device)
    ids_val = materialize_latents(args, model, dev, "val", device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    log_metrics(args.out, {"phase": "latents", "train_shape": list(ids_train.shape),
                           "sec": time.time() - t0})

    pipeline = single.build_pipeline(args, model, device)
    if args.eval_only:
        restored = Checkpointer(os.path.join(args.out, "mage")).restore(args.eval_ckpt,
                                                                         device)
        pipeline.core.load_state_dict(restored["model"])
    else:
        stage2(args, pipeline, dev, ids_train, ids_val, args.out)
    eval_generation(args, pipeline, dev, ids_val, "val", args.out)
    eval_generation(args, pipeline, dev, ids_train, "train", args.out)


if __name__ == "__main__":
    main()
