"""End-to-end MAGE+ (continuous KL first stage) on synthetic CATER-GEN-v2.

Port of the root ``train_cater_kl_e2e.py``: the ``config/mage+_caterv2.yaml``
chain, an AutoencoderKL f8 at 128 px (continuous 16x16x4 latents), then
stage-2 MAGE+ with the stochastic branch and the same-step PID auto-beta,
on ambiguous quadrant captions (the reference pairs randomness with
ambiguous annotations: the destination inside the captioned quadrant is
under-determined, so prior samples must supply it), on the procedural
CATER stand-in. It reuses the CATER chain's pieces (``train_cater_e2e`` as
``ce``). The eval runs both samplers (the naive loop and the
causal-GroupNorm cached sampler), prior-sample diversity, quadrant-level
Action / Referring precision and FVD.

    python -m mage_tpu_torch.cli.train_cater_kl_e2e --out runs/cater_kl_e2e
    python -m mage_tpu_torch.cli.train_cater_kl_e2e --tiny --device cpu --out /tmp/cater_kl
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from mage_tpu_torch.cli import train_cater_e2e as ce
from mage_tpu_torch.cli import train_mnist_kl_e2e as mkl
from mage_tpu_torch.data.generators import cater_synthetic as cs
from mage_tpu_torch.models.autoencoder_kl import DiagonalGaussian
from mage_tpu_torch.training import e2e
from mage_tpu_torch.utils.media import save_gif

T_STORE = cs.T_STORE
log_metrics = ce.log_metrics
mse_to_psnr = ce.mse_to_psnr  # pixels in [-1, 1] -> data_range 2
# small enough for a CPU run; the same-split FVD floor needs >= 2 clips per half
TINY = dict(num_train=8, num_val=8, ae_ch=32, ae_epochs=1, stage2_epochs=2, ae_batch=4,
            batch2=4, chunk=2, eval_videos=4, gifs=1, diversity_samples=2)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="runs/cater_kl_e2e")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num-train", type=int, default=3000)
    p.add_argument("--num-val", type=int, default=600)
    # stage A: KL autoencoder f8 at 128 px (config/mage+_caterv2.yaml's
    # ddconfig, ch scaled down from the pretrained ldm's 128)
    p.add_argument("--ae-ch", type=int, default=64)
    p.add_argument("--ae-epochs", type=int, default=40)
    p.add_argument("--ae-batch", type=int, default=32)
    p.add_argument("--ae-lr", type=float, default=1e-4)
    p.add_argument("--ae-kl-weight", type=float, default=1e-6)
    p.add_argument("--ae-logvar-bias", type=float, default=0.0)
    p.add_argument("--posterior-logvar-shift", type=float, default=-4.0,
                   help="stage-2 logvar shift on the stored moments (short "
                        "MSE-dominant AE trainings leave posterior variances "
                        "near 1, which drown the stage-2 targets)")
    # stage 2
    p.add_argument("--config", default="config/mage+_caterv2.yaml")
    p.add_argument("--stage2-epochs", type=int, default=40)
    p.add_argument("--batch2", type=int, default=16)
    p.add_argument("--lr2", type=float, default=5e-5)
    p.add_argument("--static-context-prob", type=float, default=0.0,
                   help="per-sample probability of replacing the teacher-"
                        "forced context with frame 0 repeated (targets stay "
                        "GT): an anti-drift augmentation")
    p.add_argument("--motion-loss-weight", type=float, default=0.0)
    p.add_argument("--v-kl", type=float, default=None,
                   help="override the config's PID KL target (yaml: 100)")
    p.add_argument("--frames-length", type=int, default=10)
    p.add_argument("--chunk", type=int, default=50)
    p.add_argument("--skip-ae", action="store_true")
    p.add_argument("--skip-stage2", action="store_true")
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--eval-ckpt", default="final")
    p.add_argument("--eval-videos", type=int, default=48)
    p.add_argument("--diversity-samples", type=int, default=8)
    p.add_argument("--gifs", type=int, default=6)
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--no-bf16", dest="bf16", action="store_false")
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


def make_ae(args, device):
    from mage_tpu_torch.models.autoencoder_kl import AutoencoderKL

    return AutoencoderKL(
        embed_dim=4, ch=args.ae_ch, ch_mult=(1, 2, 4, 4), num_res_blocks=2,
        in_channels=3, out_ch=3, z_channels=4, double_z=True, resolution=128,
        logvar_bias=args.ae_logvar_bias,
    ).to(device)


def stage_ae(args, dev, model, out_dir):
    return e2e.run_klae_stage1(
        args, model,
        frames_at=lambda split, idx, t: ce.frames_at(dev, split, idx, t),
        t_store=T_STORE,
        n_train=int(dev["train"]["sid"].shape[0]),
        n_val=int(dev["val"]["sid"].shape[0]),
        out_dir=out_dir,
        eval_cap=64,
        ssim_count=16,
        data_range=2.0,
    )


def materialize_moments(args, model, dev, split, device):
    """Encode every stored frame -> posterior moments (N, T_STORE, 16, 16, 8)
    bf16, 5 clips (120 frames at 128 px) per chunk; the sampling happens
    per train step."""
    n = int(dev[split]["sid"].shape[0])
    return e2e.materialize(n, 5, mkl.encode_moments(
        model, lambda idx, t: ce.frames_at(dev, split, idx, t), T_STORE, device), device)


def build_pipeline(args, model, device):
    from mage_tpu_torch.config import load_config

    p = load_config(args.config).model.params
    p.first_stage_config.params.ddconfig.ch = args.ae_ch
    p.frames_length = args.frames_length
    p.generate_decoder_config.params.frames_length = args.frames_length
    if args.v_kl is not None:
        p.v_kl = args.v_kl
    if args.motion_loss_weight:
        p.motion_loss_weight = args.motion_loss_weight
    if args.tiny:
        e2e.shrink_stage2(p)
    return e2e.build_stage2_pipeline(p, model, device, args.seed)


def batch_from(args, idx, speed, mom, text, gen, static_pick=None) -> dict:
    """The batch of clips ``idx`` at ``speed`` with fresh posterior samples
    as targets; with ``static_pick`` (a (b,) bool) those clips condition on
    frame 0 repeated while their targets stay the clip."""
    pos = ce.clip_positions(speed, args.frames_length).long()
    lat = mkl.sample_latents(mom[idx[:, None], pos], gen, args.posterior_logvar_shift)
    batch = {"latents": lat, "text": text[idx], "speed": speed}
    if static_pick is not None:
        static = lat[:, :1].expand_as(lat)
        batch["context_latents"] = torch.where(static_pick[:, None, None, None, None],
                                               static, lat)
    return batch


def stage2(args, pipeline, dev, mom_train, mom_val, out_dir):
    n, n_val = int(mom_train.shape[0]), int(mom_val.shape[0])
    b, eval_b = args.batch2, min(64, n_val)

    def batch_at(gen, mom, text):
        idx, speed = e2e.draw_clips(gen, n, b)
        pick = None
        if args.static_context_prob > 0:
            # anti-drift augmentation: a random subset of the batch conditions
            # on the static context the AR rollout degenerates into
            pick = torch.rand((b,), generator=gen, device=gen.device) < args.static_context_prob
        return batch_from(args, idx, speed, mom, text, gen, pick)

    def val_batch_at(gen, mom, text):
        return batch_from(args, *e2e.draw_clips(gen, n_val, eval_b), mom, text, gen), gen

    return e2e.run_mage_plus_stage2(
        args, pipeline,
        batch_at=batch_at, val_batch_at=val_batch_at,
        mom_train=mom_train, mom_val=mom_val,
        text_train=dev["train"]["text"], text_val=dev["val"]["text"],
        out_dir=out_dir,
    )


# ---------------------------------------------------------------------------
# Evaluation: both samplers + diversity + quadrant-level precision + FVD
# ---------------------------------------------------------------------------


@torch.no_grad()
def eval_generation(args, pipeline, dev, compact, mom, split, out_dir):
    device = pipeline.device
    d = dev[split]
    g = min(args.eval_videos, int(mom.shape[0]))
    K = args.diversity_samples
    text = d["text"][:g]
    # speed 1.0: the sampled positions span all stored frames; the last
    # frame shows the settled end states (see train_cater_e2e)
    speed_f32 = torch.full((g,), 1.0, dtype=torch.float32, device=device)
    pos = ce.clip_positions(speed_f32, args.frames_length).long()
    compute_dtype = torch.bfloat16 if args.bf16 else None
    speed = speed_f32.to(compute_dtype) if compute_dtype else speed_f32
    core = mkl.compute_copy(pipeline, compute_dtype)
    lat0 = DiagonalGaussian(mom[:g, :1].float()).mode()
    if compute_dtype:
        lat0 = lat0.to(compute_dtype)
    idxg = torch.arange(g, device=device)
    gt = ce.gt_clips(dev, split, g, pos)

    vid_c, _, m = mkl.run_samplers(pipeline, core, lat0, text, speed, gt)
    recon_gt = pipeline.first_stage.decode(
        DiagonalGaussian(mom[:g][idxg[:, None], pos].float()).mode())
    mse_recon = float(torch.mean((recon_gt[:, 1:] - gt[:, 1:]) ** 2))
    log_metrics(out_dir, {
        "phase": f"samplers_{split}", "samples": g,
        "cached_psnr_vs_gt": mse_to_psnr(m["mse_c"]),
        "naive_psnr_vs_gt": mse_to_psnr(m["mse_n"]),
        "psnr_gap_db": abs(mse_to_psnr(m["mse_c"]) - mse_to_psnr(m["mse_n"])),
        "cached_vs_naive_latent_mse": m["lat_mse"],
        "latent_scale_msq": m["lat_scale"],
        "recon_psnr_vs_gt_upper_bound": mse_to_psnr(mse_recon),
    })

    # prior-sample diversity: K draws per prompt; under ambiguous quadrant
    # captions the endpoint inside the quadrant is the prior's
    vids = mkl.diversity(pipeline, core, lat0, text, speed, K)  # (K, g, L-1, 128, 128, 3)
    gt_np = gt.cpu().numpy().astype(np.float64)
    mses = ((vids - gt_np[None, :, 1:]) ** 2).mean(axis=(2, 3, 4, 5))
    psnrs = 10.0 * np.log10(4.0 / np.maximum(mses, 1e-12))
    metas = compact[split]["meta"][:g]
    bank_index, bank_arr = compact["bank_index"], compact["bank"]
    # per-draw quadrant-level precision: every draw should satisfy the
    # caption even where the endpoints differ
    pm_draws = [ce.precision_metrics(vids[k].astype(np.float64), metas, bank_index, bank_arr,
                                     quadrant_level=True)
                for k in range(min(K, 4))]
    log_metrics(out_dir, {
        "phase": f"diversity_{split}", "samples": g, "draws": K,
        "best_of_k_psnr": float(psnrs.max(axis=0).mean()),
        "worst_of_k_psnr": float(psnrs.min(axis=0).mean()),
        "mean_psnr": float(psnrs.mean()),
        "pairwise_mse": mkl.pairwise_mse(vids),
        "gt_motion_mse_scale": float(((gt_np[:, 1:] - gt_np[:, :-1]) ** 2).mean()),
        "per_draw_action_precision": [pm["action_precision"] for pm in pm_draws],
        "per_draw_referring_precision": [pm["referring_precision"] for pm in pm_draws],
    })

    gen_np = vid_c.cpu().numpy().astype(np.float64)
    pm = ce.precision_metrics(gen_np, metas, bank_index, bank_arr, quadrant_level=True)
    pm_gt = ce.precision_metrics(gt_np[:, 1:], metas, bank_index, bank_arr,
                                 quadrant_level=True)
    log_metrics(out_dir, {
        "phase": f"generation_{split}", "samples": g,
        "gen_psnr_vs_gt": mse_to_psnr(m["mse_c"]),
        "recon_psnr_vs_gt_upper_bound": mse_to_psnr(mse_recon),
        **pm,
        "gt_action_precision_ceiling": pm_gt["action_precision"],
        "gt_referring_precision_ceiling": pm_gt["referring_precision"],
    })
    recon_np = recon_gt.cpu().numpy().astype(np.float64)[:, 1:]
    e2e.log_fvd(out_dir, split, "CATER-GEN-v2", gt_np[:, 1:], gen_np, recon_np,
                batch_size=4, device=device)
    e2e.write_side_gifs(out_dir, split, gt_np, gen_np, args.gifs)
    strip = np.concatenate([vids[k, 0] for k in range(min(K, 4))], axis=2)
    save_gif(strip, os.path.join(out_dir, "gifs", f"{split}_diversity.gif"))


def main(argv=None):
    from mage_tpu_torch.models.pipeline import resolve_device
    from mage_tpu_torch.training.checkpoint import Checkpointer

    args = parse_args(argv)
    device = resolve_device(args.device)
    torch.manual_seed(args.seed)
    os.makedirs(args.out, exist_ok=True)
    print(f"device: {device}")
    # ambiguous quadrant captions: the reference pairs randomness with the
    # ambiguous annotation file
    compact = cs.build_compact_cater(args.num_train, args.num_val, args.seed, mode="ambiguous",
                                     dataset="CATER-GEN-v2", context_length=38)
    dev = ce.upload(compact, device)
    print(f"resident dataset: {compact['bank'].nbytes / 1e6:.1f} MB bank, "
          f"{args.num_train} train / {args.num_val} val scenes, ambiguous")

    model = make_ae(args, device)
    if args.skip_ae or args.eval_only:
        best = Checkpointer(os.path.join(args.out, "klae")).restore("best", device)
        model.load_state_dict(best["state_dict"])
    else:
        stage_ae(args, dev, model, args.out)
    if args.skip_stage2 and not args.eval_only:
        return
    t0 = time.time()
    mom_train = materialize_moments(args, model, dev, "train", device)
    mom_val = materialize_moments(args, model, dev, "val", device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    log_metrics(args.out, {"phase": "moments", "train_shape": list(mom_train.shape),
                           "sec": time.time() - t0})

    pipeline = build_pipeline(args, model, device)
    if args.eval_only:
        restored = Checkpointer(os.path.join(args.out, "mage")).restore(args.eval_ckpt,
                                                                         device)
        pipeline.core.load_state_dict(restored["model"])
    else:
        stage2(args, pipeline, dev, mom_train, mom_val, args.out)
    eval_generation(args, pipeline, dev, compact, mom_val, "val", args.out)


if __name__ == "__main__":
    main()
