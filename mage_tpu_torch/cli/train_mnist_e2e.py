"""End-to-end Moving-MNIST training on one GPU with resident data.

Port of the root ``train_mnist_e2e.py``: the reference's MNIST chain
(``train_vqvae.py`` stage 1, then ``main_mage.py`` stage 2 on
``config/mage_mnist.yaml``):

1. build the compact dataset on the host (digit bank, trajectories, caption
   tokens: what ``generators/mnist_single.py`` writes for the same seed)
   and move it to the device once;
2. stage 1: the f4 VQ-VAE on frames composed on the device;
3. materialize the latent ids of every stored frame (the encode is per
   frame, so speed-conditioned clips become gathers of ids);
4. stage 2: MAGE on the resident ids;
5. evaluate: recon MSE/PSNR/SSIM, the stage-2 losses, AR-generation PSNR
   against the ground truth and sample GIFs, all appended to
   ``<out>/e2e_metrics.json``.

The loops are ``mage_tpu_torch.training.e2e``'s; this driver supplies the
MNIST pieces. ``--device`` (default ``cuda``) is resolved before any data
is built; ``--tiny`` shrinks every knob left at its default.

    python -m mage_tpu_torch.cli.train_mnist_e2e --out runs/mnist_e2e
    python -m mage_tpu_torch.cli.train_mnist_e2e --tiny --device cpu --out /tmp/e2e
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from mage_tpu_torch.data import device_data as dd
from mage_tpu_torch.training import e2e

log_metrics = e2e.log_metrics
mse_to_psnr = e2e.mse_to_psnr
TINY = dict(num_train=64, num_val=16, dim=16, codebook=32, stage1_epochs=2,
            stage2_epochs=2, batch1=8, batch2=4, chunk=2, eval_videos=4, gifs=1)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="runs/mnist_e2e")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mnist-npz", default=None)
    p.add_argument("--num-train", type=int, default=10000)
    p.add_argument("--num-val", type=int, default=2000)
    # stage 1 (reference train_vqvae.py:197-207: dim 256, K 512, lr 1e-4,
    # beta 2.0; an epoch is one random frame per clip)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--codebook", type=int, default=512)
    p.add_argument("--stage1-epochs", type=int, default=200)
    p.add_argument("--batch1", type=int, default=128)
    p.add_argument("--lr1", type=float, default=1e-4)
    p.add_argument("--beta1", type=float, default=2.0)
    # stage 2 (config/mage_mnist.yaml)
    p.add_argument("--config", default="config/mage_mnist.yaml")
    p.add_argument("--stage2-epochs", type=int, default=201)
    p.add_argument("--batch2", type=int, default=16)
    p.add_argument("--lr2", type=float, default=5e-5)
    p.add_argument("--frames-length", type=int, default=16)
    p.add_argument("--chunk", type=int, default=50, help="train steps per chunk")
    p.add_argument("--skip-stage1", action="store_true",
                   help="restore stage 1 from <out>/vqvae/best instead of training")
    p.add_argument("--skip-stage2", action="store_true")
    p.add_argument("--eval-videos", type=int, default=64)
    p.add_argument("--gifs", type=int, default=4)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute in stage-2 training (parameters stay f32)")
    p.add_argument("--motion-loss-weight", type=float, default=0.0,
                   help="opt-in motion-weighted recon loss "
                        "(MAGECore.motion_loss_weight; 0 = reference-exact)")
    p.add_argument("--early-loss-weight", type=float, default=0.0,
                   help="opt-in early-frame loss upweighting (MAGECore.early_loss_weight)")
    p.add_argument("--early-loss-frames", type=int, default=3)
    p.add_argument("--tiny", action="store_true", help="smoke-test scale")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cpu runs the kernels' plain versions")
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
    return dd.compose_frames(dev["bank"], d["digit"][idx], d["ys"][idx, t], d["xs"][idx, t])


def upload(compact, device) -> dict:
    return {"bank": dd.normalize_bank(compact["bank"], device),
            "train": e2e.to_device(compact["train"], device),
            "val": e2e.to_device(compact["val"], device)}


def make_vqvae(args, device):
    from mage_tpu_torch.models.vqvae import VectorQuantizedVAE

    return VectorQuantizedVAE(input_dim=1, down_ratio=4, dim=args.dim, K=args.codebook).to(device)


def stage1(args, dev, model, out_dir):
    return e2e.run_vqvae_stage1(
        args, model,
        frames_at=lambda split, idx, t: frames_at(dev, split, idx, t),
        t_store=dd.SEQ_LENGTH,
        n_train=int(dev["train"]["digit"].shape[0]),
        n_val=int(dev["val"]["digit"].shape[0]),
        out_dir=out_dir,
        eval_cap=512,
        ssim_count=args.eval_videos,
        data_range=1.0,
    )


def encode_clips(model, frames_at_split, t_store, device):
    """-> ``encode_chunk(idx)``: every stored frame of clips ``idx`` through
    the VQ-VAE encode (eval mode) -> ids (len(idx), t_store, h, w) int32."""

    @torch.no_grad()
    def encode_chunk(idx):
        model.eval()
        c = idx.shape[0]
        flat_idx = idx.repeat_interleave(t_store)
        t = torch.arange(t_store, device=device).repeat(c)
        ids = model.encode(frames_at_split(flat_idx, t))
        return ids.reshape(c, t_store, *ids.shape[1:]).to(torch.int32)

    return encode_chunk


def materialize_latents(args, model, dev, split, device):
    """Encode every stored frame of ``split`` -> resident ids (N, 20, h, w)."""
    n = int(dev[split]["digit"].shape[0])
    return e2e.materialize(n, 50, encode_clips(
        model, lambda idx, t: frames_at(dev, split, idx, t), dd.SEQ_LENGTH, device),
        device)


def build_pipeline(args, model, device):
    from mage_tpu_torch.config import load_config

    p = load_config(args.config).model.params
    p.first_stage_config.params.dim = args.dim
    p.first_stage_config.params.K = args.codebook
    p.codebook_size = args.codebook
    p.frames_length = args.frames_length
    p.generate_decoder_config.params.frames_length = args.frames_length
    p.generate_decoder_config.params.out_channels = args.codebook
    if args.motion_loss_weight:
        p.motion_loss_weight = args.motion_loss_weight
    if args.early_loss_weight:
        p.early_loss_weight = args.early_loss_weight
        p.early_loss_frames = args.early_loss_frames
    if args.tiny:
        e2e.shrink_stage2(p)
    return e2e.build_stage2_pipeline(p, model, device, args.seed)


def batch_from(args, idx, speed, ids, text) -> dict:
    """The teacher-forced batch of clips ``idx`` at ``speed``: ids gathered
    at the speed-subsampled stored frames."""
    pos = dd.clip_indices(speed, frames_length=args.frames_length).long()
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


@torch.no_grad()
def eval_generation(args, pipeline, dev, ids, split, out_dir):
    """AR-generate (cached sampler) from the split's first frames; PSNR
    against the pixel ground truth and the VQ recon upper bound; a few
    GIFs."""
    device = pipeline.device
    d = dev[split]
    g = min(args.eval_videos, int(ids.shape[0]))
    text = d["text"][:g]
    speed = torch.full((g,), 0.5, dtype=torch.float32, device=device)
    pos = dd.clip_indices(speed, frames_length=args.frames_length).long()
    lat0 = ids[:g, :1]  # stored frame 0 == clip frame 0 (pos[:, 0] == 0)
    gen = pipeline.core.generate_cached(
        lat0, text, speed, generator=torch.Generator(device=device).manual_seed(7))
    video = pipeline.first_stage.decode(gen)
    length = pos.shape[1]
    gt_flat = frames_at(dev, split, torch.arange(g, device=device).repeat_interleave(length),
                        pos.reshape(-1))
    gt = gt_flat.reshape(g, length, *gt_flat.shape[1:])
    recon_gt = pipeline.first_stage.decode(ids[:g][torch.arange(g, device=device)[:, None], pos])
    mse_gen = float(torch.mean((video - gt[:, 1:]) ** 2))
    mse_recon = float(torch.mean((recon_gt[:, 1:] - gt[:, 1:]) ** 2))
    log_metrics(out_dir, {
        "phase": f"generation_{split}", "samples": g,
        "gen_psnr_vs_gt": mse_to_psnr(mse_gen),
        "recon_psnr_vs_gt_upper_bound": mse_to_psnr(mse_recon),
    })
    # GT | generated; x2 maps [-0.5, 0.5] to the GIF writer's [-1, 1]
    e2e.write_side_gifs(out_dir, split, gt.cpu().numpy(), video.cpu().numpy(), args.gifs,
                        scale=2.0)
    return mse_gen


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
    dev = upload(compact, device)
    print(f"resident dataset: {compact['bank'].nbytes / 1e6:.1f} MB bank, "
          f"{args.num_train} train / {args.num_val} val clips")

    model = make_vqvae(args, device)
    if args.skip_stage1:
        best = Checkpointer(os.path.join(args.out, "vqvae")).restore("best", device)
        model.load_state_dict(best["state_dict"])
    else:
        stage1(args, dev, model, args.out)
    if args.skip_stage2:
        return
    t0 = time.time()
    ids_train = materialize_latents(args, model, dev, "train", device)
    ids_val = materialize_latents(args, model, dev, "val", device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    log_metrics(args.out, {"phase": "latents", "train_shape": list(ids_train.shape),
                           "sec": time.time() - t0})

    pipeline = build_pipeline(args, model, device)
    stage2(args, pipeline, dev, ids_train, ids_val, args.out)
    eval_generation(args, pipeline, dev, ids_val, "val", args.out)
    eval_generation(args, pipeline, dev, ids_train, "train", args.out)


if __name__ == "__main__":
    main()
