"""The shared end-to-end training harness of the five ``train_*_e2e`` chains.

Port of ``mage_tpu/training/e2e.py``:

- ``run_vqvae_stage1``: the discrete stage-1 loop (VQ-VAE f4/f8) with
  optional codebook restart and a motion-frame eval;
- ``run_klae_stage1``: the MAGE+ stage-1 loop (AutoencoderKL);
- ``run_mage_stage2``: the discrete stage-2 loop (fixed beta and alpha);
- ``run_mage_plus_stage2``: the continuous stage-2 loop with the same-step
  PID auto-beta;
- ``materialize``: the chunked encode-everything loop;
- ``log_metrics``, ``mse_to_psnr``, ``log_fvd``, ``write_side_gifs``.

Each chain supplies its dataset callbacks: frame composition on the device
(``frames_at``), batch assembly (``batch_at``, ``val_batch_at``) and its
generation evals. Where JAX fuses ``args.chunk`` steps into one
``jax.lax.scan``, the loops here run the port's step functions
(``vqvae_trainer``, ``autoencoder_kl_trainer``, ``mage_trainer``) in a
Python loop, so the straight-through, the bf16 parameter copies and the PID
are the trainers' own. Every draw comes from a ``torch.Generator`` on the
models' device seeded from ``args.seed`` (JAX's key streams cannot be
reproduced), so a chain's metrics follow JAX's closely, not bit for bit.
Records go to ``<out>/e2e_metrics.json`` with JAX's phase names and keys;
checkpoints are ``torch.save`` files under ``<out>/{vqvae,klae,mage}``, and
each stage resumes from its ``last`` checkpoint at the next epoch.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from mage_tpu_torch.evals.metrics import ssim as np_ssim
from mage_tpu_torch.models.autoencoder_kl import DiagonalGaussian
from mage_tpu_torch.models.pipeline import init_weights
from mage_tpu_torch.training import autoencoder_kl_trainer as kt
from mage_tpu_torch.training import vqvae_trainer as vt
from mage_tpu_torch.training.autoresume import save_last, try_restore_last
from mage_tpu_torch.training.checkpoint import Checkpointer
from mage_tpu_torch.training.lr import epoch_lr
from mage_tpu_torch.training.mage_trainer import (
    make_mage_eval_step,
    make_mage_optimizer,
    make_mage_train_step,
)
from mage_tpu_torch.training.pid import initial_pid_state
from mage_tpu_torch.utils.media import save_gif


def log_metrics(out_dir, record, name="e2e_metrics.json"):
    record = dict(record, time=time.time())
    with open(os.path.join(out_dir, name), "a") as fp:
        fp.write(json.dumps(record) + "\n")
    print("METRIC", json.dumps(record), flush=True)


def write_report(record, run: str, name: str, path=None) -> str:
    """Write a diagnostic's report as indented JSON to ``path``, by default
    ``<run>/<name>.json`` -> the path written."""
    path = path or os.path.join(run, f"{name}.json")
    with open(path, "w") as fp:
        json.dump(record, fp, indent=2)
    print(f"report: {path}", flush=True)
    return path


def mse_to_psnr(mse, data_range=1.0):
    """PSNR in dB of one MSE (-> float) or of a tensor of them (-> tensor)."""
    if torch.is_tensor(mse):
        return 10.0 * torch.log10(data_range**2 / torch.clamp(mse, min=1e-12))
    return float(10.0 * np.log10(data_range**2 / max(mse, 1e-12)))


def _mean_ssim(f_np: np.ndarray, r_np: np.ndarray, data_range: float) -> float:
    """Mean SSIM over a batch; grayscale scores [..., 0], RGB scores each
    channel separately (the two conventions the chains used)."""
    if f_np.shape[-1] == 1:
        return float(np.mean([np_ssim(a, b, data_range=data_range)
                              for a, b in zip(f_np[..., 0], r_np[..., 0])]))
    return float(np.mean([
        np_ssim(a, b, data_range=data_range)
        for fa, fb in zip(f_np, r_np)
        for a, b in zip(np.moveaxis(fa, -1, 0), np.moveaxis(fb, -1, 0))
    ]))


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _randint(gen: torch.Generator, high: int, size: int) -> torch.Tensor:
    return torch.randint(0, high, (size,), generator=gen, device=gen.device)


def _restore_rng(gen: torch.Generator, state: torch.Tensor) -> None:
    gen.set_state(state.cpu())


def _n_params(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


# ---------------------------------------------------------------------------
# Stage 1 (discrete): VQ-VAE
# ---------------------------------------------------------------------------


def run_vqvae_stage1(
    args,
    model,
    *,
    frames_at: Callable,          # (split, idx, t) -> (len(idx), H, W, C) frames
    t_store: int,                 # stored frames per clip
    n_train: int,
    n_val: int,
    out_dir: str,
    eval_cap: int = 512,
    motion_frame: Optional[int] = None,  # also eval recon at this frame
    ssim_count: int = 32,
    data_range: float = 1.0,
):
    """The shared discrete stage-1 loop on ``model`` (on its device):
    ``args.chunk``-step train chunks on frames composed on the device,
    periodic val recon with eval-mode BatchNorm and codebook occupancy,
    optional dead-code restart (every other epoch), autoresume, best/final
    checkpoints, final SSIM. Trains ``model`` in place and returns it."""
    dev = _device(model)
    init_weights(model, torch.Generator().manual_seed(args.seed))
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.reset_running_stats()
    optimizer = vt.make_optimizer(model, args.lr1)
    train_step = vt.make_train_step(model, optimizer, args.beta1)
    print(f"stage-1 params: {_n_params(model):,}")
    ckpt = Checkpointer(os.path.join(out_dir, "vqvae"))
    b = args.batch1
    n = n_train
    eval_b = min(eval_cap, n_val)

    @torch.no_grad()
    def eval_recon(frame_idx: int):
        """Val recon MSE with eval-mode BN (the statistics stage 2 uses)."""
        model.eval()
        s = torch.arange(eval_b, device=dev)
        frames = frames_at("val", s, torch.full((eval_b,), frame_idx, device=dev))
        ids = model.encode(frames)
        recon = model.decode(ids)
        return (float(torch.mean((recon - frames) ** 2)), int(torch.unique(ids).numel()),
                frames, recon)

    restart_fn = (vt.make_restart_dead_codes(model)
                  if getattr(args, "codebook_restart", False) else None)

    def state(step, gen):
        return {"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                "step": step, "rng": gen.get_state()}

    steps_per_epoch = max(n // b, 1)
    chunks = max(round(steps_per_epoch / args.chunk), 1)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    best = float("inf")
    start_epoch = 0
    step = 0
    resumed = try_restore_last(ckpt, map_location=dev)
    if resumed is not None:
        start_epoch, best, st = resumed
        model.load_state_dict(st["model"])
        optimizer.load_state_dict(st["optimizer"])
        step = int(st["step"])
        _restore_rng(gen, st["rng"])
        print(f"stage-1 autoresume: epoch {start_epoch}, best mse {best:.6f}")
    t0 = time.time()
    loss = float("nan")
    for epoch in range(start_epoch, args.stage1_epochs):
        for _ in range(chunks):
            losses = []
            for _ in range(args.chunk):
                s = _randint(gen, n, b)
                f = _randint(gen, t_store, b)
                losses.append(train_step(frames_at("train", s, f), args.lr1)["total"])
                step += 1
            loss = torch.stack(losses).mean()
        if restart_fn is not None and epoch % 2 == 1:
            s = _randint(gen, n, 64)
            f = _randint(gen, t_store, 64)
            restart_fn(frames_at("train", s, f), generator=gen)
        if epoch % 10 == 0 or epoch == args.stage1_epochs - 1:
            rec = {"phase": "stage1", "epoch": epoch, "train_loss": float(loss)}
            mse, used, _, _ = eval_recon(0)
            if motion_frame is not None:
                # mid-action frame: off-grid offsets, rotation phases, the
                # content whose recon bounds generation
                rec["val_recon_psnr_motion"] = mse_to_psnr(eval_recon(motion_frame)[0],
                                                           data_range)
            rec.update(
                val_recon_mse=mse,
                val_recon_psnr=mse_to_psnr(mse, data_range),
                codebook_used=used,
                sec_per_epoch=(time.time() - t0) / (epoch - start_epoch + 1),
            )
            log_metrics(out_dir, rec)
            if mse < best:
                best = mse
                ckpt.save("best", {"step": step, "state_dict": model.state_dict(),
                                   "optimizer": optimizer.state_dict()})
            save_last(ckpt, epoch, best, state(step, gen))
    ckpt.save("final", {"step": step, "state_dict": model.state_dict(),
                        "optimizer": optimizer.state_dict()})

    mse, used, frames, recon = eval_recon(0)
    f_np = frames[:ssim_count].float().cpu().numpy()
    r_np = recon[:ssim_count].float().cpu().numpy()
    log_metrics(out_dir, {
        "phase": "stage1_final", "val_recon_mse": mse,
        "val_recon_psnr": mse_to_psnr(mse, data_range),
        "val_ssim": _mean_ssim(f_np, r_np, data_range),
        "codebook_used": used,
    })
    return model


# ---------------------------------------------------------------------------
# Stage 1 (continuous): AutoencoderKL
# ---------------------------------------------------------------------------


def run_klae_stage1(
    args,
    model,
    *,
    frames_at: Callable,          # (split, idx, t) -> frames
    t_store: int,
    n_train: int,
    n_val: int,
    out_dir: str,
    eval_cap: int = 64,
    ssim_count: int = 16,
    data_range: float = 2.0,
):
    """The shared MAGE+ stage-1 loop: MSE + tiny-KL AutoencoderKL training,
    mode-decoded val recon (eval mode: the decoder's gn_conv kernels),
    autoresume, best/final checkpoints. Trains ``model`` in place and
    returns it."""
    dev = _device(model)
    init_weights(model, torch.Generator().manual_seed(args.seed))
    optimizer = kt.make_optimizer(model, args.ae_lr)
    train_step = kt.make_train_step(model, optimizer, args.ae_kl_weight)
    print(f"KL-AE params: {_n_params(model):,}")
    ckpt = Checkpointer(os.path.join(out_dir, "klae"))
    b = args.ae_batch
    n = n_train
    eval_b = min(eval_cap, n_val)

    @torch.no_grad()
    def eval_recon():
        model.eval()
        s = torch.arange(eval_b, device=dev)
        frames = frames_at("val", s, torch.zeros((eval_b,), dtype=torch.long, device=dev))
        recon = model.decode(DiagonalGaussian(model.encode_moments(frames)).mode())
        return float(torch.mean((recon - frames) ** 2)), frames, recon

    steps_per_epoch = max(n // b, 1)
    chunks = max(round(steps_per_epoch / args.chunk), 1)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    best = float("inf")
    start_epoch = 0
    step = 0
    resumed = try_restore_last(ckpt, map_location=dev)
    if resumed is not None:
        start_epoch, best, st = resumed
        model.load_state_dict(st["model"])
        optimizer.load_state_dict(st["optimizer"])
        step = int(st["step"])
        _restore_rng(gen, st["rng"])
        print(f"klae autoresume: epoch {start_epoch}, best mse {best:.6f}")
    t0 = time.time()
    rec = float("nan")
    for epoch in range(start_epoch, args.ae_epochs):
        for _ in range(chunks):
            recs = []
            for _ in range(args.chunk):
                s = _randint(gen, n, b)
                f = _randint(gen, t_store, b)
                recs.append(train_step(frames_at("train", s, f), generator=gen)
                            ["reconstruction"])
                step += 1
            rec = torch.stack(recs).mean()
        if epoch % 5 == 0 or epoch == args.ae_epochs - 1:
            mse, _, _ = eval_recon()
            log_metrics(out_dir, {
                "phase": "klae", "epoch": epoch, "train_recon": float(rec),
                "val_recon_mse": mse,
                "val_recon_psnr": mse_to_psnr(mse, data_range),
                "sec_per_epoch": (time.time() - t0) / (epoch - start_epoch + 1),
            })
            if mse < best:
                best = mse
                ckpt.save("best", {"step": step, "state_dict": model.state_dict()})
            save_last(ckpt, epoch, best,
                      {"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                       "step": step, "rng": gen.get_state()})
    ckpt.save("final", {"step": step, "state_dict": model.state_dict()})

    mse, frames, recon = eval_recon()
    f_np = frames[:ssim_count].float().cpu().numpy()
    r_np = recon[:ssim_count].float().cpu().numpy()
    log_metrics(out_dir, {
        "phase": "klae_final", "val_recon_mse": mse,
        "val_recon_psnr": mse_to_psnr(mse, data_range),
        "val_ssim": _mean_ssim(f_np, r_np, data_range),
    })
    return model


# ---------------------------------------------------------------------------
# Latent materialization
# ---------------------------------------------------------------------------


def materialize(n: int, chunk: int, encode_chunk: Callable, device=None):
    """Chunked encode-everything loop with one chunk shape: the final short
    chunk is padded with index 0 and sliced (the padding rows re-encode
    clip 0 and are discarded)."""
    outs = []
    for i in range(0, n, chunk):
        idx = torch.arange(i, min(i + chunk, n), device=device)
        if idx.shape[0] < chunk:
            idx = torch.cat([idx, idx.new_zeros(chunk - idx.shape[0])])
            outs.append(encode_chunk(idx)[: n - i])
        else:
            outs.append(encode_chunk(idx))
    return torch.cat(outs)[:n]


# ---------------------------------------------------------------------------
# Stage 2
# ---------------------------------------------------------------------------


def fixed_beta_loss(pipeline, terms: dict, beta, alpha) -> torch.Tensor:
    """The discrete chains' loss: prediction + beta * KL (on the stochastic
    branch) + alpha * speed_l2, the alpha term whether or not the branch is
    on, as JAX's e2e loop weights it."""
    final = terms["prediction"] + beta * terms.get("kl_loss", 0.0) + alpha * terms["speed_l2"]
    terms["final_loss"] = final
    return final


def _resume_stage2(ckpt, pipeline, optimizer, extra: dict, gen):
    """Resume the stage-2 loop state from ``last``: -> (start_epoch, best,
    step), the core, optimizer, generator and ``extra`` tensors restored."""
    resumed = try_restore_last(ckpt, map_location=pipeline.device)
    if resumed is None:
        return 0, float("inf"), 0
    # the optimizer state and the generator ride in "last": a continued run
    # is step-equivalent to an uninterrupted one (modulo the cosine schedule
    # now spanning the new --stage2-epochs)
    start_epoch, best, st = resumed
    pipeline.core.load_state_dict(st["model"])
    optimizer.load_state_dict(st["optimizer"])
    _restore_rng(gen, st["rng"])
    for k, v in extra.items():
        v.copy_(st[k])
    print(f"stage-2 autoresume: epoch {start_epoch}, best {best:.4f}")
    return start_epoch, best, int(st["step"])


def run_mage_stage2(
    args,
    pipeline,
    *,
    batch_at: Callable,        # (generator, lat_train, text_train) -> batch dict
    val_batch_at: Callable,    # (generator, lat_val, text_val) -> (batch, generator)
    lat_train, lat_val, text_train, text_val,
    out_dir: str,
    last_every: int = 10,      # full-state resume cadence (epochs)
    legacy_resume_epoch: Optional[int] = None,  # mnist2 --resume path
):
    """The shared discrete stage-2 loop: teacher-forced train chunks on
    precomputed latents (no first-stage encode in the step), cosine LR per
    epoch, bf16 compute copies under ``args.bf16``, periodic val loss,
    best/last/final checkpoints and full-state autoresume."""
    dev = pipeline.device
    alpha, beta = pipeline.alpha, pipeline.beta
    compute_dtype = torch.bfloat16 if args.bf16 else None
    print(f"stage-2 params: {_n_params(pipeline.core):,}")
    optimizer = make_mage_optimizer(pipeline.core)
    train_step = make_mage_train_step(pipeline, optimizer, compute_dtype, loss=fixed_beta_loss)
    eval_step = make_mage_eval_step(pipeline, compute_dtype)

    n = int(lat_train.shape[0])
    steps_per_epoch = max(n // args.batch2, 1)
    chunks = max(round(steps_per_epoch / args.chunk), 1)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 2)
    ckpt = Checkpointer(os.path.join(out_dir, "mage"))
    start_epoch, best, step = _resume_stage2(ckpt, pipeline, optimizer, {}, gen)
    if start_epoch == 0 and legacy_resume_epoch is not None:
        # older runs saved the weights only: warm-restart Adam (its moments
        # re-estimate within ~100 steps)
        restored = ckpt.restore("final", map_location=dev)
        pipeline.core.load_state_dict(restored["model"])
        step = int(restored["step"])
        start_epoch = legacy_resume_epoch
        # fold the resume point into the stream: without it the resumed run
        # replays the original run's draws
        gen.manual_seed((args.seed + 2) * 1_000_003 + start_epoch)
        print(f"resumed stage 2 at epoch {start_epoch} (step {step})")
    t0 = time.time()
    loss = float("nan")
    for epoch in range(start_epoch, args.stage2_epochs):
        lr = epoch_lr(args.lr2, epoch, args.stage2_epochs, cos=True)
        for _ in range(chunks):
            losses = []
            for _ in range(args.chunk):
                batch = batch_at(gen, lat_train, text_train)
                losses.append(train_step(batch, lr, beta, alpha, generator=gen)["final_loss"])
                step += 1
            loss = torch.stack(losses).mean()
        if epoch % 5 == 0 or epoch == args.stage2_epochs - 1:
            val_batch, val_gen = val_batch_at(
                torch.Generator(device=dev).manual_seed(args.seed + 3), lat_val, text_val)
            terms = eval_step(val_batch, beta, alpha, generator=val_gen)
            val_loss = float(fixed_beta_loss(pipeline, terms, beta, alpha))
            log_metrics(out_dir, {
                "phase": "stage2", "epoch": epoch, "lr": lr, "train_loss": float(loss),
                "val_loss": val_loss, "val_prediction": float(terms["prediction"]),
                "sec_per_epoch": (time.time() - t0) / (epoch - start_epoch + 1),
            })
            improved = val_loss < best
            if improved:
                best = val_loss
                ckpt.save("best", {"step": step, "model": pipeline.core.state_dict()})
            # save_last also on improvement: a crash between "best" and the
            # next cadenced "last" would otherwise resume with a stale best
            # metric and overwrite the true pre-crash best checkpoint
            if improved or epoch % last_every == 0 or epoch == args.stage2_epochs - 1:
                save_last(ckpt, epoch, best,
                          {"model": pipeline.core.state_dict(),
                           "optimizer": optimizer.state_dict(), "step": step,
                           "rng": gen.get_state()})
    ckpt.save("final", {"step": step, "model": pipeline.core.state_dict()})
    return pipeline.core


def run_mage_plus_stage2(
    args,
    pipeline,
    *,
    batch_at: Callable,        # (generator, mom_train, text_train) -> batch dict
    val_batch_at: Callable,    # (generator, mom_val, text_val) -> (batch, generator)
    mom_train, mom_val, text_train, text_val,
    out_dir: str,
):
    """The shared continuous stage-2 loop: stochastic first-stage targets
    drawn per step inside ``batch_at``, the same-step PID auto-beta of the
    train step, the PID state checkpointed with the loop state."""
    dev = pipeline.device
    compute_dtype = torch.bfloat16 if args.bf16 else None
    print(f"stage-2 params: {_n_params(pipeline.core):,}")
    optimizer = make_mage_optimizer(pipeline.core)
    train_step = make_mage_train_step(pipeline, optimizer, compute_dtype)
    eval_step = make_mage_eval_step(pipeline, compute_dtype)

    n = int(mom_train.shape[0])
    steps_per_epoch = max(n // args.batch2, 1)
    chunks = max(round(steps_per_epoch / args.chunk), 1)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 2)
    ckpt = Checkpointer(os.path.join(out_dir, "mage"))
    pid_state = initial_pid_state(dev)
    # the PID state resumes too: beta regulation continues where the
    # crashed run left off instead of winding up again
    start_epoch, best, step = _resume_stage2(ckpt, pipeline, optimizer,
                                             {"pid": pid_state}, gen)
    t0 = time.time()
    for epoch in range(start_epoch, args.stage2_epochs):
        lr = epoch_lr(args.lr2, epoch, args.stage2_epochs, cos=True)
        for _ in range(chunks):
            losses, kls = [], []
            for _ in range(args.chunk):
                batch = batch_at(gen, mom_train, text_train)
                terms = train_step(batch, lr, pid_state, 0.0, generator=gen)
                pid_state = terms["_pid_state"]
                losses.append(terms["final_loss"])
                kls.append(terms["kl_loss"])
                step += 1
            loss, klm = torch.stack(losses).mean(), torch.stack(kls).mean()
            beta = terms["beta"]
        if epoch % 5 == 0 or epoch == args.stage2_epochs - 1:
            loss, klm, beta = float(loss), float(klm), float(beta)
            val_batch, val_gen = val_batch_at(
                torch.Generator(device=dev).manual_seed(args.seed + 3), mom_val, text_val)
            terms = eval_step(val_batch, beta, 0.0, generator=val_gen)
            val_loss = float(terms["final_loss"])
            log_metrics(out_dir, {
                "phase": "stage2", "epoch": epoch, "lr": lr,
                "train_loss": loss, "train_kl": klm, "beta": beta,
                "val_loss": val_loss, "val_prediction": float(terms["prediction"]),
                "sec_per_epoch": (time.time() - t0) / (epoch - start_epoch + 1),
            })
            improved = val_loss < best
            if improved:
                best = val_loss
                ckpt.save("best", {"step": step, "model": pipeline.core.state_dict()})
            if improved or epoch % 10 == 0 or epoch == args.stage2_epochs - 1:
                save_last(ckpt, epoch, best,
                          {"model": pipeline.core.state_dict(),
                           "optimizer": optimizer.state_dict(), "step": step,
                           "pid": pid_state, "rng": gen.get_state()})
    ckpt.save("final", {"step": step, "model": pipeline.core.state_dict()})
    return pipeline.core


# ---------------------------------------------------------------------------
# Shared driver pieces
# ---------------------------------------------------------------------------


def apply_tiny(args, parser, values: dict) -> None:
    """``--tiny``: every knob in ``values`` that the command line left at
    its default takes the smoke-test value, so an explicit flag (a resume
    test's ``--stage2-epochs``, a smaller ``--num-train``) still wins."""
    for k, v in values.items():
        if getattr(args, k) == parser.get_default(k):
            setattr(args, k, v)


def add_fvd_extractor_args(parser) -> None:
    """The chains' and ``eval_fvd_e2e``'s choice of FVD extractor (JAX's
    ``MAGE_FVD_EXTRACTOR`` and ``MAGE_I3D_TORCH``), for
    ``evals.fvd.resolve_extractor``."""
    parser.add_argument("--fvd-extractor", default=None, metavar="DIR",
                        help="a train_fvd_extractor run to embed the FVD clips (JAX's "
                             "MAGE_FVD_EXTRACTOR); it must fit the dataset. Default: "
                             "runs/fvd_extractor{,_mnist} where one fits, else random-init I3D")
    parser.add_argument("--i3d-checkpoint", default=None, metavar="FILE",
                        help="a pytorch-i3d Kinetics checkpoint for the FVD (JAX's "
                             "MAGE_I3D_TORCH)")


def shrink_stage2(params) -> None:
    """The ``--tiny`` stage-2 widths of every chain: width 64, a 1-layer
    text encoder, a 3-block decoder."""
    params.vision_width = 64
    params.text_encoder_config.params.transformer_width = 64
    params.text_encoder_config.params.output_dim = 64
    params.text_encoder_config.params.transformer_layers = 1
    params.ma_config.params.d_model = 64
    for k, v in dict(in_channels=64, model_channels=64, layers=3).items():
        params.generate_decoder_config.params[k] = v


def build_stage2_pipeline(params, first_stage: torch.nn.Module, device, seed: int):
    """``MagePipeline(**params)`` on ``device``, its core at the JAX core's
    init distributions drawn from ``seed`` (``pipeline.init_weights``), with
    ``first_stage``'s trained weights strictly loaded into its frozen first
    stage (the config's ``ckpt_path`` dropped)."""
    from mage_tpu_torch.models.pipeline import MagePipeline

    params.first_stage_config.params.pop("ckpt_path", None)
    pipeline = MagePipeline(**params, device=device, seed=seed)
    pipeline.first_stage.model.load_state_dict(first_stage.state_dict(), strict=True)
    return pipeline


def draw_clips(gen: torch.Generator, n: int, b: int):
    """-> (b,) clip indices in [0, n) and (b,) speeds in [0, 1), drawn from
    ``gen`` on its device: what every chain's ``batch_at`` samples."""
    idx = torch.randint(0, n, (b,), generator=gen, device=gen.device)
    speed = torch.rand((b,), generator=gen, device=gen.device)
    return idx, speed


def to_device(split: dict, device, skip=("meta",)) -> dict:
    """A compact split's numpy arrays -> tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in split.items() if k not in skip}


# ---------------------------------------------------------------------------
# Shared eval helpers
# ---------------------------------------------------------------------------


def log_fvd(out_dir: str, split: str, dataset: str, real: np.ndarray,
            gen: np.ndarray, recon: np.ndarray, batch_size: int = 4, *,
            device=None, i3d_checkpoint: Optional[str] = None,
            extractor_dir: Optional[str] = None):
    """FVD of generated and reconstructed clips against the ground truth
    through ``evals.fvd.resolve_extractor`` (on ``device``), with the
    same-split floor beside every number. Inputs are (G, L, H, W, 3) RGB in
    [-1, 1]. Beside JAX's keys the record lists under ``fvd_regularized``
    the numbers whose covariance root ``frechet_distance`` took with 1e-6 I
    added (a singular product, fewer clips than feature dims), which the
    JAX package does not give."""
    from mage_tpu_torch.evals.fvd import (compute_fvd, fvd_same_split_floor,
                                          resolve_extractor)

    extractor, fvd_prov, fvd_dim = resolve_extractor(
        dataset, batch_size=batch_size, i3d_checkpoint=i3d_checkpoint,
        extractor_dir=extractor_dir, device=device)
    clip = lambda v: np.clip(v, -1.0, 1.0).astype(np.float32)  # noqa: E731
    fvd_gen, reg_gen = compute_fvd(clip(real), clip(gen), extractor,
                                   return_regularized=True)
    fvd_recon, reg_recon = compute_fvd(clip(real), clip(recon), extractor,
                                       return_regularized=True)
    fvd_floor, reg_floor = fvd_same_split_floor(clip(real), extractor,
                                                return_regularized=True)
    log_metrics(out_dir, {
        "phase": f"fvd_{split}", "samples": int(real.shape[0]),
        "fvd_gen_vs_gt": float(fvd_gen),
        "fvd_recon_vs_gt": float(fvd_recon),
        "fvd_same_split_floor": float(fvd_floor),
        "fvd_gen_over_floor": float(fvd_gen / max(fvd_floor, 1e-12)),
        "extractor": fvd_prov,
        "feature_dim": fvd_dim,
        "fvd_regularized": [name for name, reg in (
            ("fvd_gen_vs_gt", reg_gen), ("fvd_recon_vs_gt", reg_recon),
            ("fvd_same_split_floor", reg_floor)) if reg],
    })


def write_side_gifs(out_dir: str, split: str, gt, gen, count: int,
                    scale: float = 1.0):
    """GT | generated side-by-side GIFs; ``scale`` maps the pixel range to
    the GIF writer's [-1, 1] (2.0 for [-0.5, 0.5] grayscale chains)."""
    few = np.asarray(gen[:count], np.float32)
    few_gt = np.asarray(gt[:count], np.float32)
    os.makedirs(os.path.join(out_dir, "gifs"), exist_ok=True)
    for i in range(few.shape[0]):
        side = np.concatenate([few_gt[i, 1:], few[i]], axis=2) * scale
        save_gif(side, os.path.join(out_dir, "gifs", f"{split}_{i}.gif"))
