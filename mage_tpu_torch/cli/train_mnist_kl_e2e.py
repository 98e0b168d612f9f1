"""End-to-end MAGE+ (continuous KL first stage) on Single Moving MNIST.

Port of the root ``train_mnist_kl_e2e.py``: train an AutoencoderKL (f4,
64 px), materialize its per-frame posterior moments once, train the
continuous stage 2 (``config/mage+_mnist.yaml``: the stochastic branch and
the same-step PID auto-beta) on a fresh posterior sample of those moments
every step, then evaluate generation with both samplers (the naive loop and
the causal-GroupNorm cached sampler), prior-sample diversity and FVD.

``--ambiguous`` re-captions every clip "the digit D is moving here and
there ." (the reference's CATER randomness recipe), so the direction must
come from the prior.

    python -m mage_tpu_torch.cli.train_mnist_kl_e2e --out runs/mnist_klp_e2e --ambiguous
    python -m mage_tpu_torch.cli.train_mnist_kl_e2e --tiny --device cpu --out /tmp/e2e_kl
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from mage_tpu_torch.cli import train_mnist_e2e as single
from mage_tpu_torch.cli.train_mnist2_e2e import to_rgb
from mage_tpu_torch.data import device_data as dd
from mage_tpu_torch.models.autoencoder_kl import DiagonalGaussian
from mage_tpu_torch.training import e2e
from mage_tpu_torch.utils.media import save_gif

log_metrics = e2e.log_metrics
mse_to_psnr = e2e.mse_to_psnr
# sized as JAX's: the same-split FVD floor needs >= 2 clips per half
TINY = dict(num_train=16, num_val=8, ae_ch=32, ae_epochs=2, stage2_epochs=2, ae_batch=8,
            batch2=4, chunk=2, eval_videos=4, gifs=1, diversity_samples=2)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="runs/mnist_klp_e2e")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mnist-npz", default=None)
    p.add_argument("--num-train", type=int, default=10000)
    p.add_argument("--num-val", type=int, default=2000)
    p.add_argument("--ambiguous", action="store_true",
                   help="strip motion clauses from captions (the CATER "
                        "randomness recipe): direction comes from the prior")
    # stage A: KL autoencoder (f4 at 64 px)
    p.add_argument("--ae-ch", type=int, default=64)
    p.add_argument("--ae-epochs", type=int, default=40)
    p.add_argument("--ae-batch", type=int, default=64)
    p.add_argument("--ae-lr", type=float, default=1e-4)
    p.add_argument("--ae-kl-weight", type=float, default=1e-6)
    p.add_argument("--ae-logvar-bias", type=float, default=0.0,
                   help="constant shift on the AE's predicted logvar")
    p.add_argument("--posterior-logvar-shift", type=float, default=0.0,
                   help="stage-2-only logvar shift when sampling targets from "
                        "the stored moments")
    # stage 2
    p.add_argument("--config", default="config/mage+_mnist.yaml")
    p.add_argument("--stage2-epochs", type=int, default=50)
    p.add_argument("--batch2", type=int, default=16)
    p.add_argument("--lr2", type=float, default=5e-5)
    p.add_argument("--v-kl", type=float, default=10.0)
    p.add_argument("--frames-length", type=int, default=16)
    p.add_argument("--chunk", type=int, default=50)
    p.add_argument("--skip-ae", action="store_true")
    p.add_argument("--skip-stage2", action="store_true")
    p.add_argument("--eval-only", action="store_true",
                   help="restore <out>/mage/<--eval-ckpt> and run the "
                        "evaluation suite only")
    p.add_argument("--eval-ckpt", default="final")
    p.add_argument("--eval-videos", type=int, default=32)
    p.add_argument("--diversity-samples", type=int, default=8)
    p.add_argument("--gifs", type=int, default=4)
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--no-bf16", dest="bf16", action="store_false")
    p.add_argument("--tiny", action="store_true",
                   help="smoke-test scale: shrinks only the flags left at their defaults "
                        "(JAX's train_mnist_kl_e2e.py --tiny overrides explicit flags too)")
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


def make_ambiguous_text(compact, seed, context_length=32):
    """Re-caption every clip "the digit D is moving here and there ."
    (vocabulary-covered filler words)."""
    from mage_tpu_torch.data.generators import mnist_common as mc
    from mage_tpu_torch.data.tokenizers import MNIST_VOCAB, VocabTokenizer

    _, labels = mc.load_digit_bank(None, seed=seed)
    tok = VocabTokenizer(MNIST_VOCAB, split_mode="whitespace")
    for split in ("train", "val"):
        d = compact[split]
        d["text"] = np.stack([
            tok.encode_padded("the digit %d is moving here and there ." % labels[i],
                              context_length)
            for i in d["digit"]
        ]).astype(np.int32)
    return compact


frames_at = single.frames_at


def make_ae(args, device):
    from mage_tpu_torch.models.autoencoder_kl import AutoencoderKL

    return AutoencoderKL(
        embed_dim=4, ch=args.ae_ch, ch_mult=(1, 2, 4), num_res_blocks=2,
        in_channels=1, out_ch=1, z_channels=4, double_z=True, resolution=64,
        logvar_bias=args.ae_logvar_bias,
    ).to(device)


def stage_ae(args, dev, model, out_dir):
    return e2e.run_klae_stage1(
        args, model,
        frames_at=lambda split, idx, t: frames_at(dev, split, idx, t),
        t_store=dd.SEQ_LENGTH,
        n_train=int(dev["train"]["digit"].shape[0]),
        n_val=int(dev["val"]["digit"].shape[0]),
        out_dir=out_dir,
        eval_cap=256,
        ssim_count=32,
        data_range=1.0,
    )


def encode_moments(model, frames_at_split, t_store, device):
    """-> ``encode_chunk(idx)``: every stored frame of clips ``idx`` through
    the KL encoder (eval mode) -> bf16 moments (len(idx), t_store, h, w, 8)."""

    @torch.no_grad()
    def encode_chunk(idx):
        model.eval()
        c = idx.shape[0]
        flat_idx = idx.repeat_interleave(t_store)
        t = torch.arange(t_store, device=device).repeat(c)
        moments = model.encode_moments(frames_at_split(flat_idx, t))
        return moments.reshape(c, t_store, *moments.shape[1:]).to(torch.bfloat16)

    return encode_chunk


def materialize_moments(args, model, dev, split, device):
    """Encode every stored frame -> posterior moments (N, 20, 16, 16, 8)
    bf16 (mean, logvar); the sampling happens per train step."""
    n = int(dev[split]["digit"].shape[0])
    return e2e.materialize(n, 50, encode_moments(
        model, lambda idx, t: frames_at(dev, split, idx, t), dd.SEQ_LENGTH, device), device)


def build_pipeline(args, model, device):
    from mage_tpu_torch.config import load_config

    p = load_config(args.config).model.params
    p.first_stage_config.params.ddconfig.ch = args.ae_ch
    p.frames_length = args.frames_length
    p.generate_decoder_config.params.frames_length = args.frames_length
    p.v_kl = args.v_kl
    if args.tiny:
        e2e.shrink_stage2(p)
    return e2e.build_stage2_pipeline(p, model, device, args.seed)


def sample_latents(moments, gen, logvar_shift=0.0, noise=None):
    """(..., 8) bf16 moments -> (..., 4) bf16 latents: one posterior sample
    per call (the stochastic per-step targets), its standard normal
    ``noise`` or, when not given, drawn from ``gen`` in f32.
    ``logvar_shift`` quiets the posterior post hoc."""
    mom = moments.float()
    if logvar_shift:
        mean, logvar = mom.chunk(2, dim=-1)
        mom = torch.cat([mean, logvar + logvar_shift], dim=-1)
    post = DiagonalGaussian(mom)
    if noise is None:
        noise = torch.randn(post.mean.shape, generator=gen, device=gen.device)
    return post.sample(noise).to(torch.bfloat16)


def batch_from(args, idx, speed, mom, text, gen) -> dict:
    pos = dd.clip_indices(speed, frames_length=args.frames_length).long()
    lat = sample_latents(mom[idx[:, None], pos], gen, args.posterior_logvar_shift)
    return {"latents": lat, "text": text[idx], "speed": speed}


def stage2(args, pipeline, dev, mom_train, mom_val, out_dir):
    n, n_val = int(mom_train.shape[0]), int(mom_val.shape[0])
    eval_b = min(64, n_val)

    def batch_at(gen, mom, text):
        return batch_from(args, *e2e.draw_clips(gen, n, args.batch2), mom, text, gen)

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
# Evaluation
# ---------------------------------------------------------------------------


def compute_copy(pipeline, compute_dtype):
    """The core to sample with: itself, or a copy cast to ``compute_dtype``
    (the f32 masters stay as they are)."""
    import copy

    if compute_dtype is None:
        return pipeline.core
    return copy.deepcopy(pipeline.core).to(compute_dtype)


def run_samplers(pipeline, core, lat0, text, speed, gt, seed=7):
    """Both samplers from the same prior draw -> (cached video, naive video,
    metrics dict) with the videos in f32."""
    out = {}
    for name, method in (("cached", core.generate_cached), ("naive", core.generate)):
        gen = torch.Generator(device=pipeline.device).manual_seed(seed)
        lat = method(lat0, text, speed, generator=gen)
        vid = pipeline.first_stage.decode(lat)
        out[name] = (lat.float(), vid.float())
    metrics = {
        "lat_mse": float(torch.mean((out["cached"][0] - out["naive"][0]) ** 2)),
        "lat_scale": float(torch.mean(out["naive"][0] ** 2)),
        "mse_c": float(torch.mean((out["cached"][1] - gt[:, 1:]) ** 2)),
        "mse_n": float(torch.mean((out["naive"][1] - gt[:, 1:]) ** 2)),
    }
    return out["cached"][1], out["naive"][1], metrics


def diversity(pipeline, core, lat0, text, speed, draws):
    """``draws`` cached-sampler videos per prompt, prior draws seeded 100 + k
    -> (K, g, L-1, H, W, C) f32 numpy."""
    return np.stack([
        pipeline.first_stage.decode(core.generate_cached(
            lat0, text, speed,
            generator=torch.Generator(device=pipeline.device).manual_seed(100 + k)))
        .float().cpu().numpy()
        for k in range(draws)
    ])


def pairwise_mse(vids) -> float:
    pair, cnt = 0.0, 0
    for a in range(vids.shape[0]):
        for c in range(a + 1, vids.shape[0]):
            pair += ((vids[a] - vids[c]) ** 2).mean()
            cnt += 1
    return float(pair / max(cnt, 1))


@torch.no_grad()
def eval_generation(args, pipeline, dev, mom, split, out_dir):
    """Both samplers + prior-sample diversity + FVD on ``split``."""
    device = pipeline.device
    d = dev[split]
    g = min(args.eval_videos, int(mom.shape[0]))
    K = args.diversity_samples
    text = d["text"][:g]
    speed_f32 = torch.full((g,), 0.5, dtype=torch.float32, device=device)
    # the indices from the f32 speed (exact threshold math); the model's
    # input in the compute dtype, as the bf16 cache expects
    pos = dd.clip_indices(speed_f32, frames_length=args.frames_length).long()
    compute_dtype = torch.bfloat16 if args.bf16 else None
    speed = speed_f32.to(compute_dtype) if compute_dtype else speed_f32
    core = compute_copy(pipeline, compute_dtype)
    # frame-0 latents: the posterior mode of the stored moments
    lat0 = DiagonalGaussian(mom[:g, :1].float()).mode()
    if compute_dtype:
        lat0 = lat0.to(compute_dtype)
    length = pos.shape[1]
    rows = torch.arange(g, device=device).repeat_interleave(length)
    gt_flat = dd.compose_frames(dev["bank"], d["digit"][:g].repeat_interleave(length),
                                d["ys"][rows, pos.reshape(-1)], d["xs"][rows, pos.reshape(-1)])
    gt = gt_flat.reshape(g, length, *gt_flat.shape[1:])

    vid_c, _, m = run_samplers(pipeline, core, lat0, text, speed, gt)
    log_metrics(out_dir, {
        "phase": f"samplers_{split}", "samples": g,
        "cached_psnr_vs_gt": mse_to_psnr(m["mse_c"]),
        "naive_psnr_vs_gt": mse_to_psnr(m["mse_n"]),
        "psnr_gap_db": abs(mse_to_psnr(m["mse_c"]) - mse_to_psnr(m["mse_n"])),
        "cached_vs_naive_latent_mse": m["lat_mse"],
        "latent_scale_msq": m["lat_scale"],
    })

    # prior-sample diversity: K draws per prompt
    vids = diversity(pipeline, core, lat0, text, speed, K)  # (K, g, L-1, 64, 64, 1)
    gt_np = gt.cpu().numpy()[:, 1:]
    mses = ((vids - gt_np[None]) ** 2).mean(axis=(2, 3, 4, 5))  # (K, g)
    psnrs = 10.0 * np.log10(1.0 / np.maximum(mses, 1e-12))
    log_metrics(out_dir, {
        "phase": f"diversity_{split}", "samples": g, "draws": K,
        "best_of_k_psnr": float(psnrs.max(axis=0).mean()),
        "worst_of_k_psnr": float(psnrs.min(axis=0).mean()),
        "mean_psnr": float(psnrs.mean()),
        "pairwise_mse": pairwise_mse(vids),
        "gt_motion_mse_scale": float(((gt_np[:, 1:] - gt_np[:, :-1]) ** 2).mean()),
    })

    vid_c_np = vid_c.cpu().numpy()
    arange = torch.arange(g, device=device)
    recon = pipeline.first_stage.decode(
        DiagonalGaussian(mom[:g][arange[:, None], pos].float()).mode())
    recon_np = recon.float().cpu().numpy()[:, 1:]
    e2e.log_fvd(out_dir, split, "MovingMNIST", to_rgb(gt_np), to_rgb(vid_c_np),
                to_rgb(recon_np), batch_size=8, device=device,
                i3d_checkpoint=args.i3d_checkpoint, extractor_dir=args.fvd_extractor)
    e2e.write_side_gifs(out_dir, split, gt.cpu().numpy(), vid_c_np, args.gifs, scale=2.0)
    # diversity strip: K draws of prompt 0 side by side
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

    compact = dd.build_compact_single_mnist(args.num_train, args.num_val, args.seed,
                                            args.mnist_npz)
    if args.ambiguous:
        compact = make_ambiguous_text(compact, args.seed)
    dev = single.upload(compact, device)
    print(f"resident dataset: {args.num_train} train / {args.num_val} val, "
          f"ambiguous={args.ambiguous}")

    model = make_ae(args, device)
    if args.skip_ae:
        best = Checkpointer(os.path.join(args.out, "klae")).restore("best", device)
        model.load_state_dict(best["state_dict"])
    else:
        stage_ae(args, dev, model, args.out)
    if args.skip_stage2:
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
    eval_generation(args, pipeline, dev, mom_val, "val", args.out)


if __name__ == "__main__":
    main()
