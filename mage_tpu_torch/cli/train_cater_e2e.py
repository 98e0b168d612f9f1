"""End-to-end CATER-GEN training on the synthetic stand-in, on one GPU.

Port of the root ``train_cater_e2e.py``: the flagship recipe, the f8
VQ-VAE at 128x128 and the stage-2 MAGE of ``config/mage_{caterv1,caterv2}
.yaml`` (d=512, 6 axial layers, 16x16 latents, K=512, speed conditioning,
explicit captions), on procedurally rendered CATER scenes
(``data/generators/cater_synthetic``). The sprite bank, the per-frame
placements and the caption tokens live on the device; frames are composed
there. After stage 1 the ids of every stored frame are materialized, stage 2
trains on them, and the eval reports AR-generation PSNR, tracking-based
Action / Referring precision (masked normalized cross-correlation of each
object's sprite on the generated pixels) and FVD.

    python -m mage_tpu_torch.cli.train_cater_e2e --out runs/cater_e2e --bf16
    python -m mage_tpu_torch.cli.train_cater_e2e --tiny --device cpu --out /tmp/cater
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from mage_tpu_torch.cli import train_mnist_e2e as single
from mage_tpu_torch.data import device_data as dd
from mage_tpu_torch.data.generators import cater_synthetic as cs
from mage_tpu_torch.training import e2e

T_STORE = cs.T_STORE  # 24 stored frames per clip
log_metrics = e2e.log_metrics
TINY = dict(num_train=48, num_val=12, dim=16, codebook=32, stage1_epochs=2,
            stage2_epochs=2, batch1=8, batch2=4, chunk=2, eval_videos=4, gifs=1)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="runs/cater_e2e")
    p.add_argument("--dataset", default="caterv2", choices=["caterv1", "caterv2"],
                   help="caterv1: two-object {cone, snitch} scenes, 30-token "
                        "shape-only vocabulary, config/mage_caterv1.yaml")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num-train", type=int, default=3000)
    p.add_argument("--num-val", type=int, default=600)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--codebook", type=int, default=512)
    p.add_argument("--stage1-epochs", type=int, default=80)
    p.add_argument("--batch1", type=int, default=64)
    p.add_argument("--lr1", type=float, default=1e-4)
    p.add_argument("--beta1", type=float, default=2.0)
    p.add_argument("--config", default=None,
                   help="stage-2 YAML (default: config/mage_{dataset}.yaml)")
    p.add_argument("--stage2-epochs", type=int, default=40)
    p.add_argument("--batch2", type=int, default=16)
    p.add_argument("--lr2", type=float, default=5e-5)
    p.add_argument("--frames-length", type=int, default=10)
    p.add_argument("--chunk", type=int, default=50)
    p.add_argument("--skip-stage1", action="store_true")
    p.add_argument("--skip-stage2", action="store_true")
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--eval-videos", type=int, default=48)
    p.add_argument("--gifs", type=int, default=6)
    p.add_argument("--codebook-restart", action="store_true",
                   help="re-seed dead codebook entries every other epoch "
                        "from encoder features (off = reference parity)")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cpu runs the kernels' plain versions")
    return p


def parse_args(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    if args.tiny:
        e2e.apply_tiny(args, p, TINY)
    return args


def mse_to_psnr(mse, data_range=2.0):
    """Pixels are in [-1, 1] (the CATER transform chain's Normalize(.5, .5))."""
    return e2e.mse_to_psnr(mse, data_range)


def dataset_name(args) -> str:
    return "CATER-GEN-v1" if args.dataset == "caterv1" else "CATER-GEN-v2"


def upload(compact, device) -> dict:
    """The compact scenes on ``device``: the sprite bank and background in
    [-1, 1] (alpha kept as stored), normalized on the host, where the
    quotient is exact (see ``device_data.normalize_bank``)."""
    def norm(u8):
        return torch.as_tensor(np.asarray(u8)).to(torch.float32) / 127.5 - 1.0

    bank = torch.cat([norm(compact["bank"][..., :3]),
                      torch.as_tensor(compact["bank"][..., 3:]).to(torch.float32)], dim=-1)
    return {"bank": bank.to(device), "background": norm(compact["background"]).to(device),
            "train": e2e.to_device(compact["train"], device),
            "val": e2e.to_device(compact["val"], device)}


def frames_at(dev, split, idx, t):
    """Compose (len(idx),) frames, video idx x stored-frame t, on the device."""
    d = dev[split]
    return dd.compose_frames_cater(dev["bank"], dev["background"],
                                   d["sid"][idx, t], d["top"][idx, t], d["left"][idx, t])


def clip_positions(speed, frames_length):
    """Speed-conditioned stored-frame indices (interval 1 + 1.4 * speed, so
    count = round(24 / interval) >= frames_length: no padding), in the
    integer linspace-floor math of ``device_data.clip_indices``. The
    quotient is a true f32 division (torch's scalar / tensor multiplies by
    the reciprocal)."""
    interval = 1.0 + 1.4 * torch.as_tensor(speed).to(torch.float32)
    q = torch.full_like(interval, float(T_STORE)) / interval
    count = torch.clamp(torch.round(q).to(torch.int32), min=frames_length)
    i = torch.arange(frames_length, dtype=torch.int32, device=interval.device)
    return (i * (T_STORE - 1)) // torch.clamp(count[..., None] - 1, min=1)


def make_vqvae(args, device):
    from mage_tpu_torch.models.vqvae import VectorQuantizedVAE

    return VectorQuantizedVAE(input_dim=3, down_ratio=8, dim=args.dim, K=args.codebook).to(device)


def stage1(args, dev, model, out_dir):
    return e2e.run_vqvae_stage1(
        args, model,
        frames_at=lambda split, idx, t: frames_at(dev, split, idx, t),
        t_store=T_STORE,
        n_train=int(dev["train"]["sid"].shape[0]),
        n_val=int(dev["val"]["sid"].shape[0]),
        out_dir=out_dir,
        eval_cap=128,
        # mid-action frame: sprites at off-grid offsets, rotation phases,
        # z-lift, the content whose recon bounds generation
        motion_frame=T_STORE // 2,
        ssim_count=32,
        data_range=2.0,
    )


def materialize_latents(args, model, dev, split, device):
    """Encode all stored frames of every clip -> ids (N, T_STORE, 16, 16), 5
    clips (120 frames at 128 px) per chunk."""
    n = int(dev[split]["sid"].shape[0])
    return e2e.materialize(n, 5, single.encode_clips(
        model, lambda idx, t: frames_at(dev, split, idx, t), T_STORE, device), device)


def build_pipeline(args, model, device):
    from mage_tpu_torch.config import load_config

    p = load_config(args.config).model.params
    p.first_stage_config.params.dim = args.dim
    p.first_stage_config.params.K = args.codebook
    p.codebook_size = args.codebook
    p.randomness = False  # explicit captions (the caterv2 yaml pairs
    p.beta = 0.0          # randomness with ambiguous ones)
    p.frames_length = args.frames_length
    p.generate_decoder_config.params.frames_length = args.frames_length
    p.generate_decoder_config.params.out_channels = args.codebook
    if args.tiny:
        e2e.shrink_stage2(p)
    return e2e.build_stage2_pipeline(p, model, device, args.seed)


def batch_from(args, idx, speed, ids, text) -> dict:
    pos = clip_positions(speed, args.frames_length).long()
    return {"latents": ids[idx[:, None], pos], "text": text[idx], "speed": speed}


def stage2(args, pipeline, dev, ids_train, ids_val, out_dir):
    n, n_val = int(ids_train.shape[0]), int(ids_val.shape[0])
    eval_b = min(64, n_val)

    def batch_at(gen, ids, text):
        return batch_from(args, *e2e.draw_clips(gen, n, args.batch2), ids, text)

    def val_batch_at(gen, ids, text):
        return batch_from(args, *e2e.draw_clips(gen, n_val, eval_b), ids, text), gen

    return e2e.run_mage_stage2(
        args, pipeline,
        batch_at=batch_at, val_batch_at=val_batch_at,
        lat_train=ids_train, lat_val=ids_val,
        text_train=dev["train"]["text"], text_val=dev["val"]["text"],
        out_dir=out_dir,
    )


# ---------------------------------------------------------------------------
# Evaluation: PSNR + tracking-based Action / Referring precision
# ---------------------------------------------------------------------------


def _ncc_near(frame: np.ndarray, tmpl: np.ndarray, mask: np.ndarray,
              top: int, left: int, radius: int) -> float:
    """Masked zero-mean normalized cross-correlation of the (32, 32, 3)
    sprite template against every window of ``frame`` whose top-left lies
    within ``radius`` of (top, left) -> the best score."""
    from numpy.lib.stride_tricks import sliding_window_view

    y0 = max(top - radius, 0)
    x0 = max(left - radius, 0)
    y1 = min(top + radius + 1, frame.shape[0] - 31)
    x1 = min(left + radius + 1, frame.shape[1] - 31)
    if y0 >= y1 or x0 >= x1:
        return -1.0
    crop = frame[y0 : y1 + 31, x0 : x1 + 31].astype(np.float64)

    m = mask.astype(np.float64)
    k = max(m.sum(), 1.0)
    t0 = tmpl.astype(np.float64) * m[..., None]
    tmean = t0.sum((0, 1)) / k  # per-channel masked template mean
    t = t0 - tmean * m[..., None]
    tn = np.sqrt((t**2).sum())
    wins = sliding_window_view(crop, (32, 32), axis=(0, 1))  # (Y, X, 3, 32, 32)
    mt = np.moveaxis(t, -1, 0)  # (3, 32, 32)
    dot = np.einsum("yxchw,chw->yx", wins, mt, optimize=True)
    s1 = np.einsum("yxchw,hw->yxc", wins, m, optimize=True)
    s2 = np.einsum("yxchw,hw->yxc", wins**2, m, optimize=True)
    var = np.maximum(s2 - s1**2 / k, 0.0).sum(-1)  # float error -> tiny neg
    ncc = dot / np.maximum(np.sqrt(var) * tn, 1e-9)
    # NCC alone misfires on near-flat windows (var ~ 0) and across shaded
    # sprites (the shared lambertian ramp): gate on real contrast (masked
    # per-pixel RMS >= 5 gray levels) and on color identity (masked mean
    # within 45 per channel of the template's)
    contrast_ok = np.sqrt(var / (3.0 * k)) >= 5.0
    color_ok = np.abs(s1 / k - tmean).mean(-1) <= 45.0
    smap = np.where(contrast_ok & color_ok, ncc, 0.0)
    return float(smap.max())


def precision_metrics(videos: np.ndarray, metas: list, bank_index: dict,
                      bank_arr: np.ndarray, tau: float = 0.45,
                      radius: int = 10, quadrant_level: bool = False) -> dict:
    """Action / Referring precision of (G, L, 128, 128, 3) videos in
    [-1, 1] against their scene metadata, by sprite tracking on the last
    frame: destination presence (slide, pick-place, contain), departure
    from the start, the containment target's occlusion, rotation staying in
    place, each scored by masked NCC against the object's sprite (the best
    rotation phase). ``quadrant_level=True`` scores slide and pick-place
    destinations anywhere in the captioned quadrant (ambiguous captions)."""
    acts, refs = [], []
    by_action: dict = {}
    for vid, meta in zip(videos, metas):
        frame_last = (vid[-1] + 1.0) * 127.5
        by_name = {o["instance"]: o for o in meta["objects"]}

        def templates(o):
            keys = [(o["shape"], o["size"], o["color"], o["material"], p)
                    for p in range(cs.N_PHASES)]
            idxs = [bank_index[k] for k in keys if k in bank_index]
            return [bank_arr[i] for i in idxs]

        def best_near(frame, o, pos, radius=radius):
            top, left = cs.world_to_topleft(*pos)
            best = -1.0
            for spr in templates(o):
                best = max(best, _ncc_near(
                    frame, spr[..., :3].astype(np.float64), spr[..., 3] > 0,
                    top, left, radius))
            return best

        for name, items in meta["movements"].items():
            if not items:
                continue
            action, target, _s, _e = items[0]
            o = by_name[name]
            start = o["locations"]["0"][:2]
            end = o["locations"]["1"][:2]
            at_end = best_near(frame_last, o, (end[0], end[1], 0.0))
            at_start = best_near(frame_last, o, (start[0], start[1], 0.0))
            if action == "_rotate":
                ok = at_start >= tau
                acts.append(ok)
            elif action == "_contain":
                tgt = by_name[target]
                tpos = tgt["locations"]["1"][:2]
                tgt_visible = best_near(frame_last, tgt, (tpos[0], tpos[1], 0.0))
                ok = at_end >= tau and tgt_visible < tau
                acts.append(ok)
                refs.append(at_end >= tau)
            else:  # _slide / _pick_place: moved to destination, left start
                if quadrant_level:
                    qc = (1.5 if end[0] >= 0 else -1.5, 1.5 if end[1] >= 0 else -1.5)
                    at_end = best_near(frame_last, o, (qc[0], qc[1], 0.0), radius=26)
                ok = at_end >= tau and (
                    at_start < tau
                    or np.hypot(end[0] - start[0], end[1] - start[1]) < 1.0
                )
                acts.append(ok)
                refs.append(at_end >= tau)
            by_action.setdefault(action, []).append(ok)
    return {
        "action_precision": float(np.mean(acts)) if acts else 0.0,
        "referring_precision": float(np.mean(refs)) if refs else 0.0,
        "action_cases": len(acts),
        "referring_cases": len(refs),
        # which semantics fail, not just how many
        "per_action": {
            k: [float(np.mean(v)), len(v)] for k, v in sorted(by_action.items())
        },
    }


def gt_clips(dev, split, g, pos):
    """The (g, L, 128, 128, 3) ground-truth clips at ``pos``, composed in one
    flat call."""
    idxg = torch.arange(g, device=pos.device)
    flat = frames_at(dev, split, idxg.repeat_interleave(pos.shape[1]), pos.reshape(-1))
    return flat.reshape(g, pos.shape[1], *flat.shape[1:])


@torch.no_grad()
def eval_generation(args, pipeline, dev, compact, ids, split, out_dir):
    device = pipeline.device
    d = dev[split]
    g = min(args.eval_videos, int(ids.shape[0]))
    text = d["text"][:g]
    # speed 1.0: the sampled positions span stored frames 0..23, so both
    # action windows complete inside the clip and the last frame shows
    # every object at its settled end state
    speed = torch.full((g,), 1.0, dtype=torch.float32, device=device)
    pos = clip_positions(speed, args.frames_length).long()
    gen = pipeline.core.generate_cached(
        ids[:g, :1], text, speed, generator=torch.Generator(device=device).manual_seed(7))
    # 128 frames per decode call: the f32 f8 decoder holds ~16 MB of
    # activations per frame
    video = pipeline.first_stage.decode(gen, max_chunk=128)
    gt = gt_clips(dev, split, g, pos)
    idxg = torch.arange(g, device=device)
    recon_gt = pipeline.first_stage.decode(ids[:g][idxg[:, None], pos], max_chunk=128)
    mse_gen = float(torch.mean((video - gt[:, 1:]) ** 2))
    mse_recon = float(torch.mean((recon_gt[:, 1:] - gt[:, 1:]) ** 2))

    gen_np = video.cpu().numpy().astype(np.float64)
    gt_np = gt.cpu().numpy().astype(np.float64)
    metas = compact[split]["meta"][:g]
    pm = precision_metrics(gen_np, metas, compact["bank_index"], compact["bank"])
    pm_gt = precision_metrics(gt_np[:, 1:], metas, compact["bank_index"], compact["bank"])
    log_metrics(out_dir, {
        "phase": f"generation_{split}", "samples": g,
        "gen_psnr_vs_gt": mse_to_psnr(mse_gen),
        "recon_psnr_vs_gt_upper_bound": mse_to_psnr(mse_recon),
        **pm,
        "gt_action_precision_ceiling": pm_gt["action_precision"],
        "gt_referring_precision_ceiling": pm_gt["referring_precision"],
    })
    recon_np = recon_gt.cpu().numpy().astype(np.float64)[:, 1:]
    e2e.log_fvd(out_dir, split, dataset_name(args), gt_np[:, 1:], gen_np, recon_np,
                batch_size=4, device=device)
    e2e.write_side_gifs(out_dir, split, gt_np, gen_np, args.gifs)
    return mse_gen


def build_dataset(args, mode: str = "explicit"):
    # context lengths match the configs' caption padding (caterv1 32, caterv2 38)
    ctx = 32 if args.dataset == "caterv1" else 38
    return cs.build_compact_cater(args.num_train, args.num_val, args.seed, mode=mode,
                                  dataset=dataset_name(args), context_length=ctx)


def main(argv=None):
    from mage_tpu_torch.models.pipeline import resolve_device
    from mage_tpu_torch.training.checkpoint import Checkpointer

    args = parse_args(argv)
    device = resolve_device(args.device)
    torch.manual_seed(args.seed)
    os.makedirs(args.out, exist_ok=True)
    print(f"device: {device}")
    if args.config is None:
        args.config = f"config/mage_{args.dataset}.yaml"
    compact = build_dataset(args)
    dev = upload(compact, device)
    print(f"resident dataset: {compact['bank'].nbytes / 1e6:.1f} MB bank "
          f"({compact['bank'].shape[0]} sprites), "
          f"{args.num_train} train / {args.num_val} val scenes")

    model = make_vqvae(args, device)
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

    pipeline = build_pipeline(args, model, device)
    if args.eval_only:
        restored = Checkpointer(os.path.join(args.out, "mage")).restore("best", device)
        pipeline.core.load_state_dict(restored["model"])
    else:
        stage2(args, pipeline, dev, ids_train, ids_val, args.out)
    eval_generation(args, pipeline, dev, compact, ids_val, "val", args.out)


if __name__ == "__main__":
    main()
