#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mage_tpu_torch``) on one GPU and check it.

Run from the repository root with ``python3 chip_smoke.py``. Phases, each
fatal on failure (exit code 1; 2 when there is no GPU or no package):

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. build the Hopper kernels from ``mage_tpu_torch/csrc`` with ``nvcc``;
3. each kernel at its path's shapes, in bf16 and f32, against its plain
   PyTorch version on the same inputs (TF32 off), and timed beside the plain
   version and, where one exists, a single PyTorch library call (the
   GroupNorm statistics kernel that feeds gn_conv has a row of its own);
4. the MAGE path: ``MagePipeline.generate`` for ``config/mage_caterv1.yaml``
   at full width, 16 frames, batch 32, bf16, random weights from a seed,
   with the kernels' launch counts read around one call;
5. a small f32 input through the same pipeline on the GPU and on the CPU
   (plain versions), which must agree;
6. the MAGE+ path: the same for ``config/mage+_caterv2.yaml`` (KL-AE first
   stage, continuous latents, cached sampler), and its f32 GPU-vs-CPU check;
7. the fused whole-block spatial route (``spatial_attn="fusedblock"``): the
   MAGE path again with its launch counts, frames/s and stage split beside
   the flat route's, then f32 GPU-vs-CPU checks of MAGE (cached sampler) and
   MAGE+ (both samplers);
8. stage-2 training (``mage_tpu_torch.training``) at ``bench_train.py``'s
   defaults: MAGE from ``config/mage_caterv1.yaml`` at full width, batch 16,
   16 frames, bf16 over f32 masters, one warm-up and 3 timed steps of
   ``make_mage_train_step`` (s/step by CUDA events, the stage split, peak
   memory with remat off and on, the losses, one vq launch a step on its
   SIMT variant); one eval step on each spatial route (4 axial, then 4
   fused-block launches); the kernels at the training shapes; MAGE+
   (``config/mage+_caterv2.yaml``, auto-beta) for 3 steps with beta in
   [0, 1]; and one f32 train step and one eval-mode loss at batch 2 on the
   GPU (kernels) against the CPU (plain versions): loss terms within 1e-4
   relative, each gradient within 1e-3 of its tensor's largest |g| (both
   also read against an f64 CPU run). The step's TFLOP per stage
   (``torch.utils.flop_counter``) and its kernel time under
   ``torch.profiler`` are printed beside the stage split;
9. stage-1 training (``vqvae_trainer``, ``autoencoder_kl_trainer``), f32:
   the vq kernel at the VQ-VAE steps' shapes (4096 tokens, 512 codes, width
   1024 and 256, with codes) against its plain version (ids equal) and its
   bound; the f8 VQ-VAE of ``config/mage_caterv1.yaml`` and the f4 one of
   ``config/mage_mnist.yaml`` at batch 16, each a warm-up, 3 timed train
   steps (s/step, the forward/backward/Adam split, peak memory; 1 vq launch a
   step), an eval step (1 launch) and a dead-code restart (2), the running
   averages untouched by the last two; the KL-AE at
   ``train_autoencoder_kl.py``'s defaults (batch 8), 3 timed steps launching
   no kernel and an eval step launching gn_conv and gn_stats once per decoder
   chain (28 each); then one train step of each VQ-VAE at batch 2 on the GPU
   against the CPU (f32, TF32 off): loss terms within 1e-4 relative, each
   gradient within 1e-3 of its tensor's largest |g|, running statistics
   within 1e-5;
10. the cli phase: the README's Moving-MNIST chains through the port's
    entry points (``mage_tpu_torch.cli``), called in process in a temporary
    directory: the generator writes 64 + 16 clips, ``device_data.
    compose_frames`` renders them bit-equal on the card, on the CPU and in
    the records; ``train_vqvae`` (f4, 1 epoch), ``main_mage`` train on
    ``config/mage_mnist.yaml`` at full width (1 epoch of 4 steps, batch 16)
    and test (2 items in f32, held to the CPU's ids on the same weights,
    then in bf16); ``train_autoencoder_kl`` (64 px, ch 64) and ``main_mage``
    train and test on ``config/mage+_mnist.yaml``. Each run's launches are
    asserted, and a line gives its wall seconds, steps, s/step by CUDA
    events, loader wait per batch and peak memory;
11. the kv-quant phase: MAGE on the main path's shapes with ``kv_quant``
    None, "int8" and "int4" (launches: no cached-attention kernel over a
    quantized cache; frames/s, AR core ms, peak memory, the caches' bytes,
    the ids shared with the unquantized run), then in f32 one slot's codes
    on the card bit-equal to the CPU's, the quantized attention over one
    cache at the main path's shapes within 1e-5 of the CPU's, one quantized
    ``decode_slot`` there held to the CPU's (its quantizations, and its
    trunk with the CPU's codes forced into the cache), and at
    batch 2 the card's generated ids no further from an f64 CPU run than
    the CPU's f32 ids;
12. the e2e phase: the five ``train_*_e2e`` chains through their entry
    points at their default widths on a few clips, one epoch of 4 steps per
    stage, each chain's launches held to the counts ``e2e_chains`` predicts,
    the first launch of each kernel at each distinct shape the chain gives
    it held against the kernel's plain version (``E2eProbe.hold``), and
    its ``e2e_metrics.json`` to its phases; a line per chain (wall s,
    s/step per stage, materialize and FVD seconds, peak memory, the holds'
    errors);
13. the evals phase, in the e2e phase's directory after the chains:
    ``cli.train_fvd_extractor`` on CATER v2 at full width (128 px, 10
    frames, batch 8) and on Moving MNIST (64 px), 16 + 8 clips, 2 steps,
    with its s/step, peak memory and calibration rows; the CATER trunk
    through ``evals.fvd.resolve_extractor`` (action-trained, 832-d, finite
    features; the MNIST family refused); ``cli.eval_fvd_e2e`` and
    ``cli.eval_speed_control`` on the ``train_mnist_e2e`` run and
    ``cli.eval_speed_control_cater`` on the ``train_cater_e2e`` run, each
    with its launches held to the counts ``evals_steps`` predicts and every
    kernel launch at a new shape held against its plain version;
14. one JSON line with every kernel's numbers, then the closing JSON line.

The cli phase also writes the trained MAGE core as a reference checkpoint
(``{"state_dict": {"module." + key: tensor}}``), converts it with
``compat.convert mage`` and samples it through ``main_mage --test_model``:
the ids must equal those of the port-format checkpoint's f32 sample.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
import traceback

# H100 SXM data-sheet peaks (at its 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12  # dense bf16 on the tensor cores

BATCH, FRAMES, RES = 32, 16, 128
VQ_N, VQ_K, VQ_D = BATCH * 16 * 16, 512, 1024  # first-frame tokens, codebook
AX_G, AX_S, AX_D, HEADS = BATCH * 16, 16, 512, 16  # one spatial block per slot
CA_N, CA_L, CA_D = BATCH * 16 * 16, FRAMES, 512  # one temporal block per slot
BF16_RTOL = 2.0 ** -7  # one bf16 rounding step of the output
F32_TOL = 1e-5
# the KL decoder's fused GroupNorm-SiLU-conv3x3 sites per 96-frame chunk:
# (H = W, C, Cout) -> calls; 480 generated frames make 5 chunks
KL_CHUNK = 96
GN_CONV_SITES = {(16, 512, 512): 10, (32, 512, 512): 6, (64, 512, 256): 1,
                 (64, 256, 256): 5, (128, 256, 128): 1, (128, 128, 128): 5}
GN_BF16_ATOL = 1e-3  # an activation that rounds to the neighbouring bf16 value
# the fused block: an intermediate (seq above all, whose residual goes
# straight to the output) that rounds to its neighbouring bf16 value moves
# the output by one bf16 step at that intermediate's magnitude, so bf16 is
# held to one step of each value plus this fraction of the largest |output|
BLOCK_BF16_ATOL_REL = 2.0 ** -7
BLOCK_BF16_VS_F32 = 1.1  # the kernel's mean bf16 error over the plain version's
NAIVE_G = BATCH * FRAMES * 16  # the naive sampler's groups per spatial block launch
# training: bench_train.py's defaults and step arguments
TRAIN_BATCH, TRAIN_STEPS = 16, 3
TRAIN_LR, TRAIN_BETA, TRAIN_ALPHA = 5e-5, 0.00025, 0.001
TRAIN_VQ_N = TRAIN_BATCH * FRAMES * 16 * 16  # tokens of one step's frozen encode
TRAIN_G = TRAIN_BATCH * FRAMES * 16  # groups of an eval step's spatial block
TERM_RTOL, GRAD_TOL = 1e-4, 1e-3  # the f32 GPU-vs-CPU training check
# stage-1 training: train_vqvae.py's batch and Adam, f32; each VQ-VAE is the
# first stage of its config: name -> (config, frame size, channels)
S1_BATCH, S1_STEPS, S1_LR, S1_BETA = 16, 3, 1e-4, 2.0
S1_VQ = {"f8": ("config/mage_caterv1.yaml", 128, 3), "f4": ("config/mage_mnist.yaml", 64, 1)}
S1_VQ_SHAPES = {"f8": (S1_BATCH * 16 * 16, 512, 1024), "f4": (S1_BATCH * 16 * 16, 512, 256)}
KL_BATCH, KL_LR, KL_WEIGHT = 8, 4.5e-6, 1e-6  # train_autoencoder_kl.py's defaults
F32_SPREAD = 2.0  # a GPU gradient as close to f64 as the CPU's, up to this factor


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters: int = 20) -> float:
    """Device time of ``fn`` a call: ``iters`` calls captured in a CUDA
    graph and replayed (after a warm-up outside it), so that no host launch
    cost is timed. For kernels shorter than their wrapper's host work."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * iters)


def bound_ms(nbytes: float, flops: float,
             flop_per_s: float = F32_FLOP_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_vq(torch, vq, gen) -> dict:
    """VQ nearest code at the main path's shape, in f32 and bf16: ids equal on
    >= 99.9% of rows, every other row a near-tie (its two distances within
    1e-5 of the row's scale), codes the exact codebook rows, the ids-only
    entry's ids those of ``nearest_with_codes``; bf16 takes the TMA/wgmma
    variant in both modes, f32 the SIMT one. The row times bf16 with codes
    host-launched (``time_ms``), the call and the clock of earlier rows; the
    log line beside it gives device times (``graph_ms``: at tens of
    microseconds the wrapper's host work outlasts the kernel) of the same
    call and its plain version, bf16 ids only, f32 beside f32 plain, and
    cuBLAS's bf16 product ``z @ cb.T`` alone (less work than the kernel: no
    |e|^2, no argmin, no gather)."""
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        z = torch.relu(torch.randn(VQ_N, VQ_D, generator=gen, device="cuda")).to(dtype)
        cb = (torch.randn(VQ_K, VQ_D, generator=gen, device="cuda") * 0.5).to(dtype)
        before = dict(vq.ROUTE_LAUNCHES)
        idx, codes = vq.nearest_with_codes(z, cb)
        ids_only = vq.nearest_codebook_indices(z, cb)
        ref_idx, ref_codes = vq.nearest_with_codes(z, cb, impl="torch")
        torch.cuda.synchronize()
        want = "wgmma" if dtype == torch.bfloat16 else "simt"
        routes = {r: vq.ROUTE_LAUNCHES[r] - before[r] for r in vq.ROUTES}
        if routes != {r: 2 if r == want else 0 for r in vq.ROUTES}:
            raise AssertionError(f"vq {dtype}: variants launched {routes}, expected {want}")
        if not torch.equal(codes, cb[idx.long()]):
            raise AssertionError(f"vq {dtype}: codes are not the rows of the ids")
        if not torch.equal(ids_only, idx):
            raise AssertionError(f"vq {dtype}: the ids-only entry gives other ids")
        zd, cbd = z.double(), cb.double()
        dist = (cbd * cbd).sum(1)[None] - 2 * zd @ cbd.T
        rows = torch.arange(VQ_N, device="cuda")
        gap = (dist[rows, idx.long()] - dist[rows, ref_idx.long()]).abs()
        scale = dist.abs().amax(1)
        mismatch = int((idx != ref_idx).sum())
        if mismatch > VQ_N * 1e-3 or bool((gap > 1e-5 * scale).any()):
            raise AssertionError(f"vq {dtype}: {mismatch} ids differ, largest gap "
                                 f"{float((gap / scale).max()):.3g} of the row scale")
        err = float((codes.float() - ref_codes.float()).abs().max())
        log(f"vq {str(dtype)[6:]}: {routes[want]} launches on the {want} variant, "
            f"{mismatch}/{VQ_N} ids differ (near-ties), max |codes - plain| {err}")
        out[dtype] = (z, cb, err)
        del zd, cbd, dist
    z32, cb32, _ = out[torch.float32]
    z, cb, err = out[torch.bfloat16]
    flops = 2.0 * VQ_N * VQ_K * VQ_D
    io_bytes = VQ_K * VQ_D * 2 + VQ_N * 4  # the codebook in, the ids out
    b, by = bound_ms(2 * VQ_N * VQ_D * 2 + io_bytes, flops, BF16_TC_FLOP_PER_S)
    ids_b, ids_by = bound_ms(VQ_N * VQ_D * 2 + io_bytes, flops, BF16_TC_FLOP_PER_S)
    f32_b, f32_by = bound_ms(2 * VQ_N * VQ_D * 4 + VQ_K * VQ_D * 4 + VQ_N * 4, flops)
    row = {
        "name": "vq_nearest", "route": "cuda", "source": "mage_tpu_torch/csrc/vq.cu",
        "replaces": "mage_tpu/ops/vq.py:53", "max_abs_err": err,
        "ms": time_ms(lambda: vq.nearest_with_codes(z, cb)),
        "plain_ms": time_ms(lambda: vq.nearest_with_codes(z, cb, impl="torch")),
        "bound_ms": b, "bound_by": by, "library_ms": None,
    }
    extra = {
        "bf16_with_codes_device_ms": graph_ms(torch, lambda: vq.nearest_with_codes(z, cb)),
        "bf16_with_codes_plain_device_ms": graph_ms(
            torch, lambda: vq.nearest_with_codes(z, cb, impl="torch"), iters=5),
        "bf16_ids_only_device_ms": graph_ms(torch, lambda: vq.nearest_codebook_indices(z, cb)),
        "bf16_ids_only_bound_ms": ids_b, "bf16_ids_only_bound_by": ids_by,
        "f32_with_codes_device_ms": graph_ms(torch, lambda: vq.nearest_with_codes(z32, cb32)),
        "f32_plain_device_ms": graph_ms(
            torch, lambda: vq.nearest_with_codes(z32, cb32, impl="torch"), iters=5),
        "f32_bound_ms": f32_b, "f32_bound_by": f32_by + " (f32 CUDA cores, SIMT variant)",
        "bf16_cublas_product_device_ms": graph_ms(torch, lambda: z @ cb.T),
    }
    log("vq at (8192, 512, 1024), beside the row: " + json.dumps(extra))
    return row


def check_axial(torch, F, ax, gen) -> dict:
    out = {}
    for dtype, rtol, atol in ((torch.float32, F32_TOL, F32_TOL),
                              (torch.bfloat16, BF16_RTOL, 1e-5)):
        q, k, v = (torch.randn(AX_G, AX_S, AX_D, generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        got = ax.axial_slot_attention(q, k, v, HEADS)
        want = ax.axial_slot_attention(q, k, v, HEADS, impl="torch")
        err = float((got.float() - want.float()).abs().max())
        if not torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol):
            raise AssertionError(f"axial {dtype}: max abs err {err}")
        log(f"axial {str(dtype)[6:]}: max |kernel - plain| {err}")
        out[dtype] = (q, k, v, err)
    q, k, v, err = out[torch.bfloat16]
    hd = AX_D // HEADS
    q4, k4, v4 = (t.view(AX_G, AX_S, HEADS, hd).transpose(1, 2) for t in (q, k, v))
    b, by = bound_ms(4 * AX_G * AX_S * AX_D * q.element_size(),
                     4.0 * AX_G * AX_S * AX_S * AX_D)
    qn, kn, vn = (torch.randn(NAIVE_G, AX_S, AX_D, generator=gen, device="cuda").to(q.dtype)
                  for _ in range(3))
    naive_bound, _ = bound_ms(4 * qn.numel() * qn.element_size(),
                              4.0 * NAIVE_G * AX_S * AX_S * AX_D)
    log(f"axial at the naive sampler's shape {tuple(qn.shape)} per call (bf16): kernel "
        f"{time_ms(lambda: ax.axial_slot_attention(qn, kn, vn, HEADS))} ms, bound "
        f"{naive_bound} ms")
    del qn, kn, vn
    return {
        "name": "axial_slot_attention", "route": "cuda",
        "source": "mage_tpu_torch/csrc/axial_attention.cu",
        "replaces": "mage_tpu/ops/axial_attention.py:27", "max_abs_err": err,
        "ms": time_ms(lambda: ax.axial_slot_attention(q, k, v, HEADS)),
        "plain_ms": time_ms(lambda: ax.axial_slot_attention(q, k, v, HEADS, impl="torch")),
        "bound_ms": b, "bound_by": by,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4)),
    }


def check_cached(torch, F, ca, gen) -> dict:
    """Held at the first, a middle and the last slot; timed as the main path
    calls it, once at each pos = 0..L-1, reported per call."""
    out = {}
    for dtype, rtol, atol in ((torch.float32, F32_TOL, F32_TOL),
                              (torch.bfloat16, BF16_RTOL, 1e-5)):
        q = torch.randn(CA_N, CA_D, generator=gen, device="cuda").to(dtype)
        ck = torch.randn(CA_L, CA_N, CA_D, generator=gen, device="cuda").to(dtype)
        cv = torch.randn(CA_L, CA_N, CA_D, generator=gen, device="cuda").to(dtype)
        err = 0.0
        for pos in (0, CA_L // 2, CA_L - 1):
            got = ca.cached_slot_attention(q, ck, cv, pos, HEADS)
            want = ca.cached_slot_attention(q, ck, cv, pos, HEADS, impl="torch")
            e = float((got.float() - want.float()).abs().max())
            if not torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol):
                raise AssertionError(f"cached {dtype} pos {pos}: max abs err {e}")
            err = max(err, e)
        log(f"cached {str(dtype)[6:]}: max |kernel - plain| {err}")
        out[dtype] = (q, ck, cv, err)
    q, ck, cv, err = out[torch.bfloat16]
    hd = CA_D // HEADS
    q4 = q.view(CA_N, HEADS, 1, hd)
    k4, v4 = (t.view(CA_L, CA_N, HEADS, hd).permute(1, 2, 0, 3) for t in (ck, cv))
    masks = [(torch.arange(CA_L, device="cuda") <= p).view(1, 1, 1, CA_L)
             for p in range(CA_L)]
    it = q.element_size()
    nbytes = sum((2 * CA_N * CA_D + 2 * (p + 1) * CA_N * CA_D) * it for p in range(CA_L))
    flops = sum(4.0 * (p + 1) * CA_N * CA_D for p in range(CA_L))
    b, by = bound_ms(nbytes / CA_L, flops / CA_L)

    def every_pos(impl):
        return lambda: [ca.cached_slot_attention(q, ck, cv, p, HEADS, impl=impl)
                        for p in range(CA_L)]

    return {
        "name": "cached_slot_attention", "route": "cuda",
        "source": "mage_tpu_torch/csrc/cached_attention.cu",
        "replaces": "mage_tpu/ops/cached_attention.py:44", "max_abs_err": err,
        "ms": time_ms(every_pos("auto"), iters=5) / CA_L,
        "plain_ms": time_ms(every_pos("torch"), iters=5) / CA_L,
        "bound_ms": b, "bound_by": by,
        "library_ms": time_ms(lambda: [F.scaled_dot_product_attention(q4, k4, v4, attn_mask=m)
                                       for m in masks], iters=5) / CA_L,
    }


def check_gn_conv(torch, F, gc, gen) -> dict:
    """Each decoder site class at the 96-frame chunk, in bf16 and f32: the
    op's output against the plain conv (``silu_conv3x3_rows``, TF32 off) on
    the affine rows the statistics kernel gave it, so the conv kernel is held
    to its own plain version on the same inputs: f32 within 1e-5 of the
    output's largest magnitude (sums of up to 4608 products in another
    order), bf16 within one rounding step plus ``GN_BF16_ATOL``. The
    statistics kernel is held to ``gn_affine_rows`` in ``check_gn_stats``;
    the distance to the whole plain chain, whose rows differ from the
    kernel's by about 3e-7 (another sum order), is printed: a few bf16
    activations near a rounding boundary then round the other way. Timed in
    bf16 beside the
    plain version, cuDNN's conv alone on the already-activated input (it
    does less work: no statistics, no affine, no SiLU), and the unfused bf16
    chain the kernel replaces: ``F.group_norm``, SiLU and a channels-last
    cuDNN conv, as the encoder's and a train-mode block's chains run."""
    per_class, err = [], 0.0
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "conv_only_ms": 0.0,
              "unfused_ms": 0.0}
    bytes_total = flops_total = 0.0
    for (hw, c, cout), calls in GN_CONV_SITES.items():
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(KL_CHUNK, hw, hw, c, generator=gen, device="cuda") * 2
                 + 0.5).to(dtype)
            gamma = torch.randn(c, generator=gen, device="cuda") * 0.5 + 1
            beta = torch.randn(c, generator=gen, device="cuda") * 0.2
            weight = torch.randn(cout, c, 3, 3, generator=gen, device="cuda") / (9 * c) ** 0.5
            bias = torch.randn(cout, generator=gen, device="cuda") * 0.1
            args = (x, gamma, beta, weight, bias)
            got = gc.gn_silu_conv3x3(*args).float()
            a, b = gc.gn_stats(x, gamma, beta)  # the rows the op used (deterministic)
            want = gc.silu_conv3x3_rows(x, a, b, weight, bias).float()
            e = float((got - want).abs().max())
            if dtype == torch.float32:
                ok = e <= F32_TOL * float(want.abs().max())
            else:
                ok = torch.allclose(got, want, rtol=BF16_RTOL, atol=GN_BF16_ATOL)
                err = max(err, e)
            if not ok:
                raise AssertionError(f"gn_conv {dtype} H={hw} {c}->{cout}: max abs err {e}")
            whole = gc.gn_silu_conv3x3(*args, impl="torch").float()
            past = int(((got - whole).abs() > GN_BF16_ATOL + BF16_RTOL * whole.abs()).sum())
            log(f"gn_conv {str(dtype)[6:]} H={hw} {c}->{cout}: max |kernel - plain on its "
                f"rows| {e}; against the whole plain chain max "
                f"{float((got - whole).abs().max())}, {past} of {got.numel()} past one step "
                f"+ {GN_BF16_ATOL}")
            del got, want, whole
        h = F.silu(x.float() * a[:, None, None, :] + b[:, None, None, :]).to(x.dtype)
        h = h.permute(0, 3, 1, 2)  # channels-last NCHW view
        w_cl = weight.to(x.dtype).contiguous(memory_format=torch.channels_last)
        b16 = bias.to(x.dtype)
        xn, g16, be16 = x.permute(0, 3, 1, 2), gamma.to(x.dtype), beta.to(x.dtype)
        nbytes = (x.numel() + KL_CHUNK * hw * hw * cout + weight.numel()) * 2 + (
            2 * KL_CHUNK * c + cout) * 4
        flops = 2.0 * KL_CHUNK * hw * hw * 9 * c * cout
        bnd, _ = bound_ms(nbytes, flops, BF16_TC_FLOP_PER_S)
        row = {"H": hw, "C": c, "Cout": cout, "calls_per_chunk": calls,
               "ms": time_ms(lambda: gc.gn_silu_conv3x3(*args), iters=10),
               "plain_ms": time_ms(lambda: gc.gn_silu_conv3x3(*args, impl="torch"), iters=3),
               "conv_only_ms": time_ms(lambda: F.conv2d(h, w_cl, b16, padding=1), iters=10),
               "unfused_ms": time_ms(lambda: F.conv2d(
                   F.silu(F.group_norm(xn, 32, g16, be16, 1e-6)), w_cl, b16, padding=1),
                   iters=10),
               "bound_ms": bnd}
        row["tflop_per_s"] = flops / row["ms"] * 1e-9
        per_class.append(row)
        n = calls * (BATCH * (FRAMES - 1) // KL_CHUNK)  # launches per generate
        for key in totals:
            totals[key] += n * row[key]
        bytes_total += n * nbytes
        flops_total += n * flops
        del x, h, xn, args
    log("gn_conv per class (bf16, 96-frame chunk): " + json.dumps(per_class))
    log("gn_conv per generate (140 launches, bf16): " + json.dumps(totals))
    n_gen = sum(GN_CONV_SITES.values()) * (BATCH * (FRAMES - 1) // KL_CHUNK)
    _, by = bound_ms(bytes_total, flops_total, BF16_TC_FLOP_PER_S)
    return {
        "name": "gn_silu_conv3x3", "route": "cuda", "source": "mage_tpu_torch/csrc/gn_conv.cu",
        "replaces": "mage_tpu/ops/gn_conv.py:60", "max_abs_err": err,
        # launch-weighted means over one generate's 140 calls
        "ms": totals["ms"] / n_gen, "plain_ms": totals["plain_ms"] / n_gen,
        "bound_ms": totals["bound_ms"] / n_gen, "bound_by": by, "library_ms": None,
        "conv_only_ms": totals["conv_only_ms"] / n_gen,
        "unfused_ms": totals["unfused_ms"] / n_gen,
    }


def check_gn_stats(torch, gc, gen) -> dict:
    """The GroupNorm statistics kernel at each decoder site class (96-frame
    chunk, 32 groups), in f32 and bf16, against ``gn_affine_rows``: a and b
    within 1e-5 relative (sums of up to 262144 values in another order), and
    bit-equal over two runs. Timed in bf16 beside the plain version and one
    ``torch.var_mean`` over the grouped view, the one PyTorch call that
    computes the same moments, all three as device time (``graph_ms``: the
    wrapper's host work outlasts the kernel at the 16- and 32-px classes);
    launch-weighted over one generate."""
    err = 0.0
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    per_class = []
    for (hw, c, _), calls in GN_CONV_SITES.items():
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(KL_CHUNK, hw, hw, c, generator=gen, device="cuda") * 2
                 + 0.5).to(dtype)
            gamma = torch.randn(c, generator=gen, device="cuda") * 0.5 + 1
            beta = torch.randn(c, generator=gen, device="cuda") * 0.2
            got = gc.gn_stats(x, gamma, beta)
            want = gc.gn_stats(x, gamma, beta, impl="torch")
            again = gc.gn_stats(x, gamma, beta)
            torch.cuda.synchronize()
            for g, w, g2 in zip(got, want, again):
                e = float((g - w).abs().max())
                if not torch.allclose(g, w, rtol=1e-5, atol=1e-5 * float(w.abs().max())):
                    raise AssertionError(f"gn_stats {dtype} H={hw} C={c}: max abs err {e}")
                if not torch.equal(g, g2):
                    raise AssertionError(f"gn_stats {dtype} H={hw} C={c}: two runs differ")
                if dtype == torch.bfloat16:
                    err = max(err, e)
        xg = x.view(KL_CHUNK, hw * hw, 32, c // 32)
        bnd, _ = bound_ms(x.numel() * 2 + (2 * c + 2 * KL_CHUNK * c) * 4, 3.0 * x.numel())
        row = {"H": hw, "C": c,
               "ms": graph_ms(torch, lambda: gc.gn_stats(x, gamma, beta)),
               "plain_ms": graph_ms(torch, lambda: gc.gn_stats(x, gamma, beta, impl="torch"),
                                    iters=5),
               "library_ms": graph_ms(torch, lambda: torch.var_mean(xg, dim=(1, 3))),
               "bound_ms": bnd}
        per_class.append(row)
        n = calls * (BATCH * (FRAMES - 1) // KL_CHUNK)
        for key in totals:
            totals[key] += n * row[key]
        del x, xg
    log("gn_stats per class (bf16, 96-frame chunk): " + json.dumps(per_class))
    log("gn_stats per generate (140 launches, bf16): " + json.dumps(totals))
    n_gen = sum(GN_CONV_SITES.values()) * (BATCH * (FRAMES - 1) // KL_CHUNK)
    return {
        "name": "gn_stats", "route": "cuda", "source": "mage_tpu_torch/csrc/gn_stats.cu",
        "replaces": "mage_tpu/ops/gn_conv.py:40", "max_abs_err": err,
        "ms": totals["ms"] / n_gen, "plain_ms": totals["plain_ms"] / n_gen,
        "bound_ms": totals["bound_ms"] / n_gen, "bound_by": "bytes",
        "library_ms": totals["library_ms"] / n_gen,
    }


def block_weights(torch, tl, gen, dtype):
    """An H/W-axis block at full width on the card (axial_dim 3, so a
    (1, 1, G, S, D) view is the flat (G, S, D) layout), with normal(0.02)
    weights and biases from ``gen`` and unit LayerNorms."""
    block = tl.AxialAttentionBlock(AX_D, HEADS, axial_dim=3)
    with torch.no_grad():
        for name, p in block.named_parameters():
            if name.startswith(("ln_1", "ln_2")):
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            else:
                p.copy_(torch.randn(p.shape, generator=gen, device="cuda") * 0.02)
    return block.to(device="cuda", dtype=dtype).eval()


def check_axial_block(torch, ax, tl, gen) -> dict:
    """The fused block at the cached sampler's shape (G=512, S=16, D=512, 16
    heads) against its plain version on the same inputs and weights: f32
    within 1e-5, bf16 within one rounding step plus ``BLOCK_BF16_ATOL_REL``
    of the largest |output| (the share of values past one step is printed).
    Timed in bf16 beside the plain version and the flat route it replaces
    (the port's ``AxialAttentionBlock``: LayerNorms, cuBLAS projections and
    MLP, the axial attention kernel, residual adds); the kernel and the flat
    block are also timed at the naive sampler's shape."""
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        block = block_weights(torch, tl, gen, dtype)
        params = block.fused_block_params()
        x = torch.randn(AX_G, AX_S, AX_D, generator=gen, device="cuda").to(dtype)
        with torch.no_grad():
            got = ax.axial_block_fused(x, params, HEADS).float()
            want = ax.axial_block_fused(x, params, HEADS, impl="torch").float()
        err = float((got - want).abs().max())
        if dtype == torch.float32:
            ok = torch.allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
        else:
            atol = BLOCK_BF16_ATOL_REL * float(want.abs().max())
            ok = torch.allclose(got, want, rtol=BF16_RTOL, atol=atol)
        if not ok:
            raise AssertionError(f"axial block {dtype}: max abs err {err}")
        log(f"axial block {str(dtype)[6:]}: max |kernel - plain| {err}, max |plain| "
            f"{float(want.abs().max())}")
        if dtype == torch.bfloat16:
            past_step = float(((got - want).abs() > BF16_RTOL * want.abs()).float().mean())
            # both round at the same points, so both are as far from the f32 math
            with torch.no_grad():
                exact = ax.axial_block_fused(x.float(), tuple(p.float() for p in params),
                                             HEADS, impl="torch")
            k_err = float((got - exact).abs().mean())
            p_err = float((want - exact).abs().mean())
            log(f"axial block bf16: share past one step of its value {past_step}; against "
                f"the f32 plain version: mean |kernel - f32| {k_err}, mean |plain - f32| "
                f"{p_err}")
            if not k_err <= BLOCK_BF16_VS_F32 * p_err:
                raise AssertionError("the bf16 kernel is further from the f32 math than "
                                     "the bf16 plain version")
        out[dtype] = (block, params, x, err)
    block, params, x, err = out[torch.bfloat16]
    d = AX_D
    n_weights = 12 * d * d + 13 * d  # matrices, biases and LayerNorm affines
    flops = 2.0 * AX_G * AX_S * 12 * d * d + 4.0 * AX_G * AX_S * AX_S * d
    b, by = bound_ms((2 * x.numel() + n_weights) * x.element_size(), flops,
                     BF16_TC_FLOP_PER_S)
    x5 = x.view(1, 1, AX_G, AX_S, AX_D)
    with torch.no_grad():
        row = {
            "name": "axial_block_fused", "route": "cuda",
            "source": "mage_tpu_torch/csrc/axial_block.cu",
            "replaces": "mage_tpu/ops/axial_attention.py:137", "max_abs_err": err,
            "ms": time_ms(lambda: ax.axial_block_fused(x, params, HEADS)),
            "plain_ms": time_ms(lambda: ax.axial_block_fused(x, params, HEADS, impl="torch")),
            "bound_ms": b, "bound_by": by, "library_ms": None,
            "unfused_ms": time_ms(lambda: block(x5)),
        }
        xn = torch.randn(NAIVE_G, AX_S, AX_D, generator=gen, device="cuda").to(x.dtype)
        naive_ms = time_ms(lambda: ax.axial_block_fused(xn, params, HEADS), iters=5)
        naive_flat_ms = time_ms(lambda: block(xn.view(1, 1, NAIVE_G, AX_S, AX_D)), iters=5)
        naive_bound, _ = bound_ms((2 * xn.numel() + n_weights) * 2, flops * NAIVE_G / AX_G,
                                  BF16_TC_FLOP_PER_S)
    log(f"axial block at the naive sampler's shape {tuple(xn.shape)} per launch (bf16): "
        f"kernel {naive_ms} ms, flat block {naive_flat_ms} ms, bound {naive_bound} ms")
    return row


def make_batch(np, batch: int, context: int, seed: int = 0) -> dict:
    """The JAX bench's inputs: random frames, a 4-word caption, a speed."""
    rng = np.random.RandomState(seed)
    text = np.zeros((batch, context), np.int64)
    text[:, 0] = 1
    text[:, 1:5] = rng.randint(3, 29, size=(batch, 4))
    text[:, 5] = 2
    return {"images": rng.rand(batch, FRAMES, RES, RES, 3).astype(np.float32) - 0.5,
            "text": text, "speed": rng.rand(batch).astype(np.float32)}


def live_head(torch, pipe, seed: int = 5) -> None:
    """JAX zero-initialises the continuous head's 1x1x1 conv, which would
    make every generated latent 0 and the decode run on zeros: give it seeded
    normal(0.02) values, in the weight's own dtype and device."""
    w = pipe.core.generate_model.out[2].weight
    with torch.no_grad():
        w.copy_(torch.randn(w.shape, generator=torch.Generator().manual_seed(seed)) * 0.02)


def run_main_path(torch, np, build_pipeline, kernels, card: str,
                  config: str = "config/mage_caterv1.yaml", want=None,
                  spatial_attn: str = "flat") -> tuple:
    """One path at full width: launch counts around one ``generate``, output
    checks, frames/s (median of 3), peak memory and the stage split.
    Returns (launch counts, the path's numbers)."""
    pipe = build_pipeline(config, FRAMES, device="cuda", seed=0, spatial_attn=spatial_attn)
    if not pipe.use_cids:
        live_head(torch, pipe)
    pipe.to(dtype=torch.bfloat16)  # both stages, as the JAX bench casts them
    batch = make_batch(np, BATCH, pipe.core.text_encoder.positions.num_embeddings)
    gen = torch.Generator(device="cuda")
    video = pipe.generate(batch, generator=gen.manual_seed(1), cached=True)  # warm-up
    torch.cuda.synchronize()

    video, launches, routes = count_launches(
        torch, kernels, lambda: pipe.generate(batch, generator=gen.manual_seed(1), cached=True))
    log(f"{config} ({spatial_attn}) launches per generate: {launches}, vq variants {routes}")
    expect(launches, want, f"{config} ({spatial_attn}) generate")
    if routes != {"simt": 0, "wgmma": launches["vq_nearest"]}:
        raise AssertionError("the main path's bf16 vq launch did not take the wgmma variant")
    if tuple(video.shape) != (BATCH, FRAMES, RES, RES, 3):
        raise AssertionError(f"output shape {tuple(video.shape)}")
    if not bool(torch.isfinite(video.float()).all()):
        raise AssertionError("non-finite frames")

    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.generate(batch, generator=gen.manual_seed(2 + i), cached=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    gen_frames = BATCH * (FRAMES - 1)
    result = {
        "config": config, "generated_frames_per_s": gen_frames / statistics.median(times),
        "generate_s": times, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "card": card, "batch": BATCH, "frames_length": FRAMES, "dtype": "bfloat16",
        "sampler": "cached", "spatial_attn": spatial_attn,
        "stage_ms": stage_breakdown(torch, pipe, batch, gen),
    }
    log("path: " + json.dumps(result))
    return launches, result


def stage_breakdown(torch, pipe, batch, gen) -> dict:
    """Device time of the three stages ``generate`` runs, by CUDA events
    around the same calls it makes (median of 3). For MAGE+ it also checks
    that the generated latents are not all equal (a live head)."""
    first = torch.from_numpy(batch["images"][:, :1]).to("cuda", torch.bfloat16)
    text = torch.from_numpy(batch["text"]).cuda()
    speed = torch.from_numpy(batch["speed"]).to("cuda", torch.bfloat16)

    def encode():
        if pipe.first_stage.is_discrete:
            return pipe.first_stage.encode(first)
        return pipe.first_stage.encode(first, generator=gen.manual_seed(1)).to(pipe.dtype)

    stages = {
        "first_frame_encode": encode,
        "ar_core": lambda: pipe.core.generate_cached(
            lat0, text, speed, generator=gen.manual_seed(1)),
        "frame_decode": lambda: pipe.first_stage.decode(latents),
    }
    lat0 = stages["first_frame_encode"]()
    latents = stages["ar_core"]()
    if not pipe.use_cids:
        spread = float(latents.float().std())
        log(f"MAGE+ generated latents: shape {tuple(latents.shape)}, std {spread:.4g}")
        if not (spread > 0 and bool(torch.isfinite(latents.float()).all())):
            raise AssertionError("MAGE+ latents are constant or not finite")
    out = {}
    for name, fn in stages.items():
        runs = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            runs.append(start.elapsed_time(end))
        out[name] = statistics.median(runs)
    return out


def run_reference_check(torch, np, build_pipeline, spatial_attn: str = "flat") -> None:
    """Batch 2, f32: the GPU (kernels) against the CPU (plain versions)."""
    batch = make_batch(np, 2, 32, seed=3)
    noise = torch.randn(2, 16, 16, 64, generator=torch.Generator().manual_seed(4))
    outs = {}
    for device in ("cuda", "cpu"):
        pipe = build_pipeline("config/mage_caterv1.yaml", FRAMES, device=device, seed=0,
                              spatial_attn=spatial_attn)
        first = torch.from_numpy(batch["images"][:, :1]).to(device)
        lat0 = pipe.first_stage.encode(first)
        ids = pipe.core.generate_cached(
            lat0, torch.from_numpy(batch["text"]).to(device),
            torch.from_numpy(batch["speed"]).to(device), video_noise=noise.to(device))
        outs[device] = (pipe, lat0.cpu(), ids.cpu())
    gpu_pipe, lat_g, ids_g = outs["cuda"]
    _, lat_c, ids_c = outs["cpu"]
    same_lat = float((lat_g == lat_c).float().mean())
    same_ids = float((ids_g == ids_c).float().mean())
    few = ids_c[:, :4]  # 8 frames keep the CPU decode short
    frames_g = gpu_pipe.first_stage.decode(few.cuda()).cpu()
    frames_c = outs["cpu"][0].first_stage.decode(few)
    frame_err = float((frames_g - frames_c).abs().max())
    log(f"f32 GPU vs CPU ({spatial_attn}): first-frame ids equal {same_lat:.4f}, generated ids equal "
        f"{same_ids:.4f}, max |frames| diff {frame_err:.3g}")
    if same_lat < 0.999 or same_ids < 0.99 or not frame_err < 1e-3:
        raise AssertionError("the GPU pipeline disagrees with the CPU reference")


def run_magep_reference_check(torch, np, build_pipeline, spatial_attn: str = "flat",
                              cached: bool = True, length: int = FRAMES) -> None:
    """Batch 1, f32: the MAGE+ path on the GPU (kernels) against the CPU
    (plain versions) with the same posterior and prior noise, on the cached
    sampler or the naive one; two generated frames are decoded, which keeps
    the CPU decode short."""
    batch = make_batch(np, 1, 38, seed=6)
    cpu_gen = torch.Generator().manual_seed(7)
    post_noise = torch.randn(1, 1, 16, 16, 4, generator=cpu_gen)
    video_noise = torch.randn(1, 16, 16, 64, generator=cpu_gen)
    outs = {}
    for device in ("cuda", "cpu"):
        pipe = build_pipeline("config/mage+_caterv2.yaml", length, device=device, seed=0,
                              spatial_attn=spatial_attn)
        live_head(torch, pipe)
        first = torch.from_numpy(batch["images"][:, :1]).to(device)
        lat0 = pipe.first_stage.encode(first, post_noise.to(device))
        sample = pipe.core.generate_cached if cached else pipe.core.generate
        latents = sample(
            lat0, torch.from_numpy(batch["text"]).to(device),
            torch.from_numpy(batch["speed"]).to(device), video_noise=video_noise.to(device))
        frames = pipe.first_stage.decode(latents[:, :2])
        outs[device] = (latents.cpu(), frames.cpu())
    lat_err = float((outs["cuda"][0] - outs["cpu"][0]).abs().max())
    frame_err = float((outs["cuda"][1] - outs["cpu"][1]).abs().max())
    log(f"MAGE+ f32 GPU vs CPU ({spatial_attn}, {'cached' if cached else 'naive'} sampler, "
        f"L={length}): max |latents| diff {lat_err:.3g} (latent std "
        f"{float(outs['cpu'][0].std()):.3g}), max |frames| diff {frame_err:.3g}")
    if not (lat_err < 1e-4 and frame_err < 1e-3):
        raise AssertionError("the GPU MAGE+ pipeline disagrees with the CPU reference")


def train_batch(torch, batch: int, context: int, seed: int) -> dict:
    """``bench_train.py``'s batch, made on the card: frames uniform in
    [-0.5, 0.5], a caption of 1, four words in 3..28 and 2, a uniform speed."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    text = torch.zeros(batch, context, dtype=torch.int64, device="cuda")
    text[:, 0] = 1
    text[:, 1:5] = torch.randint(3, 29, (batch, 4), generator=gen, device="cuda")
    text[:, 5] = 2
    return {"images": torch.rand(batch, FRAMES, RES, RES, 3, generator=gen, device="cuda") - 0.5,
            "text": text, "speed": torch.rand(batch, generator=gen, device="cuda")}


def count_launches(torch, kernels, fn):
    """``fn()`` with every launch count set to 0 just before and read just
    after -> (fn's result, the counts, the vq launches per variant)."""
    from mage_tpu_torch.ops import vq

    torch.cuda.synchronize()
    for kern in kernels.values():
        kern.launches = 0
    vq.ROUTE_LAUNCHES.update(dict.fromkeys(vq.ROUTES, 0))
    out = fn()
    torch.cuda.synchronize()
    return out, {name: kern.launches for name, kern in kernels.items()}, dict(vq.ROUTE_LAUNCHES)


def expect(launches: dict, want: dict, what: str) -> None:
    full = dict.fromkeys(launches, 0)
    full.update(want)
    if launches != full:
        raise AssertionError(f"{what}: launch counts {launches}, expected {full}")


def spatial_blocks(pipe) -> int:
    """The decoder's H and W blocks (every block but each third): 4 of 6."""
    return sum(1 for i in range(len(pipe.core.generate_model.blocks)) if i % 3)


def train_stage_split(torch, mt, pipe, opt, batch, gen) -> dict:
    """Device time of the train step's four stages (median of 3) by CUDA
    events around the calls ``make_mage_train_step`` makes: the f32 frozen
    encode, the bf16 forward through the loss, its backward, the Adam step;
    and the peak GiB of the encode alone and of the rest of the step, each
    from a reset of the peak counter (the last of the 3 runs)."""
    names = ("encode", "forward", "backward", "optimizer")
    runs = {name: [] for name in names}
    peaks = {}
    for _ in range(3):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        opt.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        events[0].record()
        latents = pipe.encode_first_stage(batch["images"])
        events[1].record()
        torch.cuda.synchronize()
        peaks["encode_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        events[2].record()
        params = mt.cast_floating(dict(pipe.core.named_parameters()), torch.bfloat16)
        terms = pipe.loss_terms({**batch, "latents": latents}, params=params,
                                compute_dtype=torch.bfloat16, generator=gen)
        loss = mt.train_loss(pipe, terms, TRAIN_BETA, TRAIN_ALPHA)
        events[3].record()
        loss.backward()
        events[4].record()
        opt.step()
        events[5].record()
        torch.cuda.synchronize()
        peaks["rest_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        for name, (a, b) in zip(names, ((0, 1), (2, 3), (3, 4), (4, 5))):
            runs[name].append(events[a].elapsed_time(events[b]))
    return {**{name: statistics.median(v) for name, v in runs.items()}, **peaks}


def train_step_flops(torch, mt, pipe, batch, gen) -> dict:
    """TFLOP of one train step's encode, forward and backward, as
    ``torch.utils.flop_counter`` counts them (products and convolutions;
    the vq kernel, a ctypes launch, is not counted)."""
    from torch.utils.flop_counter import FlopCounterMode

    out = {}
    with FlopCounterMode(display=False) as fc:
        latents = pipe.encode_first_stage(batch["images"])
    out["encode"] = fc.get_total_flops() / 1e12
    with FlopCounterMode(display=False) as fc:
        params = mt.cast_floating(dict(pipe.core.named_parameters()), torch.bfloat16)
        terms = pipe.loss_terms({**batch, "latents": latents}, params=params,
                                compute_dtype=torch.bfloat16, generator=gen)
        loss = mt.train_loss(pipe, terms, TRAIN_BETA, TRAIN_ALPHA)
    out["forward"] = fc.get_total_flops() / 1e12
    with FlopCounterMode(display=False) as fc:
        loss.backward()
    out["backward"] = fc.get_total_flops() / 1e12
    pipe.core.zero_grad(set_to_none=True)
    return out


def profile_train_step(torch, step, batch, gen, s_per_step: float) -> dict:
    """One train step under ``torch.profiler``: the device time summed over
    its kernels, that sum's share of the step's unprofiled time (the busy
    share; the kernels run on one stream), and the 12 kernels with the most
    device time. Only the kernels' own records count: an operator's record
    also carries the time of the kernels it launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(batch, TRAIN_LR, TRAIN_BETA, TRAIN_ALPHA, generator=gen)
        torch.cuda.synchronize()

    def device_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total_ms = sum(device_us(e) for e in events) / 1e3
    top = sorted(events, key=device_us, reverse=True)[:12]
    return {"device_ms": total_ms, "busy_share": total_ms / (s_per_step * 1e3),
            "top": [{"name": e.key[:80], "ms": device_us(e) / 1e3, "calls": e.count}
                    for e in top]}


def run_training(torch, build_pipeline, kernels, card: str) -> tuple:
    """MAGE stage-2 training at full width, bf16, batch 16, 16 frames:
    launch counts around the timed steps and one eval step per spatial
    route, s/step, the stage split, peak memory with remat off and on.
    Returns (launches per train step, per eval step on each route, numbers)."""
    from mage_tpu_torch.training import mage_trainer as mt

    pipe = build_pipeline("config/mage_caterv1.yaml", FRAMES, device="cuda", seed=0)
    opt = mt.make_mage_optimizer(pipe.core)
    step = mt.make_mage_train_step(pipe, opt, torch.bfloat16)
    batch = train_batch(torch, TRAIN_BATCH, pipe.core.text_encoder.positions.num_embeddings, 0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    args = (TRAIN_LR, TRAIN_BETA, TRAIN_ALPHA)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss_warm = float(step(batch, *args, generator=gen)["final_loss"])  # warm-up
    peak_off = torch.cuda.max_memory_allocated() / 2**30
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def timed_steps(on=batch):
        start.record()
        for _ in range(TRAIN_STEPS):
            terms = step(on, *args, generator=gen)
        end.record()
        return terms

    terms, launches, routes = count_launches(torch, kernels, timed_steps)
    s_per_step = start.elapsed_time(end) / TRAIN_STEPS / 1e3
    log(f"MAGE train: launches in {TRAIN_STEPS} steps {launches}, vq variants {routes}")
    expect(launches, {"vq_nearest": TRAIN_STEPS}, "MAGE train steps")
    if routes != {"simt": TRAIN_STEPS, "wgmma": 0}:
        raise AssertionError("the f32 frozen encode's vq launch did not take the SIMT variant")
    # the same steps on latents encoded once before them, as the e2e chains
    # train (training.e2e.materialize): no frozen encode in the step
    lat_batch = dict(batch, latents=pipe.encode_first_stage(batch["images"]))
    del lat_batch["images"]
    step(lat_batch, *args, generator=gen)  # warm-up
    _, lat_launches, _ = count_launches(torch, kernels, lambda: timed_steps(lat_batch))
    s_per_step_latents = start.elapsed_time(end) / TRAIN_STEPS / 1e3
    expect(lat_launches, {}, "MAGE train steps on precomputed latents")
    loss_after = float(terms["final_loss"])
    if not (math.isfinite(loss_warm) and math.isfinite(loss_after)):
        raise AssertionError(f"non-finite training loss: {loss_warm}, {loss_after}")
    stages = train_stage_split(torch, mt, pipe, opt, batch, gen)
    tflop = train_step_flops(torch, mt, pipe, batch, gen)
    tflop_per_s = {k: v / stages[k] * 1e3 for k, v in tflop.items()}
    trace = profile_train_step(torch, step, batch, gen, s_per_step)
    log("MAGE train step under torch.profiler: " + json.dumps(trace))

    pipe.core.remat = pipe.core.generate_model.remat = True
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss_remat = float(step(batch, *args, generator=gen)["final_loss"])
    peak_on = torch.cuda.max_memory_allocated() / 2**30
    stages_remat = train_stage_split(torch, mt, pipe, opt, batch, gen)
    pipe.core.remat = pipe.core.generate_model.remat = False
    if not math.isfinite(loss_remat):
        raise AssertionError("non-finite loss with remat on")

    evals, eval_ms_by_route = {}, {}
    fused_pipe = build_pipeline("config/mage_caterv1.yaml", FRAMES, device="cuda", seed=0,
                                spatial_attn="fusedblock")
    for route, pipe_r in (("flat", pipe), ("fusedblock", fused_pipe)):
        eval_step = mt.make_mage_eval_step(pipe_r, torch.bfloat16)
        eval_step(batch, TRAIN_BETA, TRAIN_ALPHA, generator=gen)  # warm-up
        terms, counts, _ = count_launches(
            torch, kernels, lambda: eval_step(batch, TRAIN_BETA, TRAIN_ALPHA, generator=gen))
        eval_ms = time_ms(lambda: eval_step(batch, TRAIN_BETA, TRAIN_ALPHA, generator=gen),
                          iters=3, warmup=0)
        op = "axial_block_fused" if route == "fusedblock" else "axial_slot_attention"
        log(f"MAGE eval step ({route}): launches {counts}, final loss "
            f"{float(terms['final_loss'])}")
        expect(counts, {"vq_nearest": 1, op: spatial_blocks(pipe_r)}, f"MAGE eval step ({route})")
        if not math.isfinite(float(terms["final_loss"])):
            raise AssertionError(f"non-finite eval loss ({route})")
        evals[route] = counts
        eval_ms_by_route[route] = eval_ms
    result = {
        "config": "config/mage_caterv1.yaml", "card": card, "batch": TRAIN_BATCH,
        "frames_length": FRAMES, "dtype": "bfloat16 over f32 masters",
        "tf32": {"cudnn": torch.backends.cudnn.allow_tf32,
                 "matmul": torch.backends.cuda.matmul.allow_tf32},
        "s_per_step": s_per_step, "s_per_step_precomputed_latents": s_per_step_latents,
        "stage_ms": stages, "stage_ms_remat": stages_remat,
        "stage_tflop": tflop, "stage_tflop_per_s": tflop_per_s,
        "peak_gib_remat_off": peak_off, "peak_gib_remat_on": peak_on,
        "eval_step_ms": eval_ms_by_route, "loss_after_warmup": loss_warm,
        "loss_after_steps": loss_after, "loss_remat_step": loss_remat,
        "vq_launches_per_step": launches["vq_nearest"] / TRAIN_STEPS,
    }
    log("MAGE training: " + json.dumps(result))
    return {k: v / TRAIN_STEPS for k, v in launches.items()}, evals, result


def run_magep_training(torch, build_pipeline, kernels, batch_size: int) -> dict:
    """MAGE+ (KL-AE first stage, auto-beta) for 3 bf16 steps: beta in [0, 1]
    and a finite PID state each step."""
    from mage_tpu_torch.training import mage_trainer as mt
    from mage_tpu_torch.training.pid import initial_pid_state

    pipe = build_pipeline("config/mage+_caterv2.yaml", FRAMES, device="cuda", seed=0)
    live_head(torch, pipe)
    if not pipe.auto_beta:
        raise AssertionError("config/mage+_caterv2.yaml should train with auto_beta")
    step = mt.make_mage_train_step(pipe, mt.make_mage_optimizer(pipe.core), torch.bfloat16)
    batch = train_batch(torch, batch_size, pipe.core.text_encoder.positions.num_embeddings, 2)
    gen = torch.Generator(device="cuda").manual_seed(3)
    state = {"pid": initial_pid_state("cuda"), "log": []}

    def steps():
        for i in range(TRAIN_STEPS):
            terms = step(batch, TRAIN_LR, state["pid"], TRAIN_ALPHA, generator=gen)
            state["pid"] = terms["_pid_state"]
            row = {"step": i, "beta": float(terms["beta"]), "kl": float(terms["kl_loss"]),
                   "final_loss": float(terms["final_loss"]), "pid": state["pid"].tolist()}
            log(f"MAGE+ train step: {json.dumps(row)}")
            if not (0.0 <= row["beta"] <= 1.0 and math.isfinite(row["final_loss"])
                    and all(math.isfinite(v) for v in row["pid"])):
                raise AssertionError(f"MAGE+ auto-beta step out of range: {row}")
            state["log"].append(row)

    start = time.perf_counter()
    _, launches, _ = count_launches(torch, kernels, steps)
    seconds = (time.perf_counter() - start) / TRAIN_STEPS
    log(f"MAGE+ train (batch {batch_size}): launches in {TRAIN_STEPS} steps {launches}, "
        f"{seconds} s/step (host clock, each step read back)")
    expect(launches, {}, "MAGE+ train steps")
    return {"batch": batch_size, "s_per_step_host": seconds, "steps": state["log"]}


def check_train_shapes(torch, vq, ax, tl, gen) -> dict:
    """The kernels at the training path's shapes, against their plain
    versions on the same inputs: f32 ids-only vq at (65536, 512, 1024), the
    frozen encode of one step (ids equal on >= 99.9% of rows, every other
    row a near-tie); the axial kernel and the fused block at an eval step's
    G=4096 in bf16 (tolerances as in their main checks). Returns per kernel
    (ms, bound ms) at that shape."""
    z = torch.relu(torch.randn(TRAIN_VQ_N, VQ_D, generator=gen, device="cuda"))
    cb = torch.randn(VQ_K, VQ_D, generator=gen, device="cuda") * 0.5
    ids = vq.nearest_codebook_indices(z, cb)
    ref = vq.nearest_codebook_indices(z, cb, impl="torch")
    zd, cbd = z.double(), cb.double()
    dist = (cbd * cbd).sum(1)[None] - 2 * zd @ cbd.T
    rows = torch.arange(TRAIN_VQ_N, device="cuda")
    gap = (dist[rows, ids.long()] - dist[rows, ref.long()]).abs()
    mismatch = int((ids != ref).sum())
    if mismatch > TRAIN_VQ_N * 1e-3 or bool((gap > 1e-5 * dist.abs().amax(1)).any()):
        raise AssertionError(f"vq f32 at the training shape: {mismatch} ids differ")
    del zd, cbd, dist, gap
    out = {"vq_nearest": (
        graph_ms(torch, lambda: vq.nearest_codebook_indices(z, cb), iters=5),
        bound_ms(TRAIN_VQ_N * VQ_D * 4 + VQ_K * VQ_D * 4 + TRAIN_VQ_N * 4,
                 2.0 * TRAIN_VQ_N * VQ_K * VQ_D)[0])}
    plain_vq = graph_ms(torch, lambda: vq.nearest_codebook_indices(z, cb, impl="torch"), iters=3)
    del z
    q, k, v = (torch.randn(TRAIN_G, AX_S, AX_D, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    got = ax.axial_slot_attention(q, k, v, HEADS).float()
    want = ax.axial_slot_attention(q, k, v, HEADS, impl="torch").float()
    if not torch.allclose(got, want, rtol=BF16_RTOL, atol=1e-5):
        raise AssertionError("axial at G=4096: kernel disagrees with plain")
    out["axial_slot_attention"] = (
        time_ms(lambda: ax.axial_slot_attention(q, k, v, HEADS)),
        bound_ms(4 * q.numel() * 2, 4.0 * TRAIN_G * AX_S * AX_S * AX_D)[0])
    block = block_weights(torch, tl, gen, torch.bfloat16)
    params = block.fused_block_params()
    with torch.no_grad():
        got = ax.axial_block_fused(q, params, HEADS).float()
        want = ax.axial_block_fused(q, params, HEADS, impl="torch").float()
        if not torch.allclose(got, want, rtol=BF16_RTOL,
                              atol=BLOCK_BF16_ATOL_REL * float(want.abs().max())):
            raise AssertionError("fused block at G=4096: kernel disagrees with plain")
        d = AX_D
        out["axial_block_fused"] = (
            time_ms(lambda: ax.axial_block_fused(q, params, HEADS)),
            bound_ms((2 * q.numel() + 12 * d * d + 13 * d) * 2,
                     2.0 * TRAIN_G * AX_S * 12 * d * d + 4.0 * TRAIN_G * AX_S * AX_S * d,
                     BF16_TC_FLOP_PER_S)[0])
    log(f"kernels at the training shapes (ms, bound ms): {json.dumps(out)}; vq f32 "
        f"{mismatch}/{TRAIN_VQ_N} ids differ (near-ties), plain vq {plain_vq} ms")
    return out


def run_train_reference_check(torch, np, build_pipeline, kernels) -> None:
    """f32, batch 2, full width, dropout 0, the posterior noise passed in:
    one train step's loss terms and every parameter's gradient on the GPU
    (kernels on the path, cuDNN off) against the CPU (plain versions), then
    the eval-mode loss terms and gradients on the same weights, where the
    spatial blocks run the axial kernel on the GPU. Terms within
    ``TERM_RTOL``; each gradient within ``GRAD_TOL`` of its tensor's
    largest |g| of the CPU's, except where the f32 CPU run is itself further
    than that from an f64 CPU run on the same weights (oneDNN's convs put
    the posterior's last 3D-conv block 1.6e-3 of its largest |g| from f64 at
    the JAX init distributions): there the GPU must be no further from the
    f64 run than ``F32_SPREAD`` times the CPU's distance, tensor by tensor,
    as in ``run_stage1_reference_check``. The GPU step is run again with
    cuDNN's convs and read against f64, not gated: at the JAX init
    distributions cuDNN's f32 3D convs put the posterior's third block
    2.16e-3 of its largest |g| from f64, where the CPU settles it under
    1e-3 and the GPU without cuDNN sits under 7.5e-4 on every tensor
    (``PERF.md``): a library's summation, not the port's code. The last motion-anchor block's c_proj bias is held to
    zero on both sides instead: it shifts every anchor position by one
    vector per channel, which AdaIN's instance norm removes, so its
    gradient is rounding noise."""
    from mage_tpu_torch.training import mage_trainer as mt

    batch = make_batch(np, 2, 32, seed=8)
    noise = torch.randn(2, 16, 16, 64, generator=torch.Generator().manual_seed(9))
    shift_invariant = "ma_encoder.blocks.0.mlp.c_proj.bias"
    outs = {}
    for run, device, cudnn in (("cuda", "cuda", False), ("cuda_cudnn", "cuda", True),
                               ("cpu", "cpu", True)):
        t0 = time.perf_counter()
        pipe = build_pipeline("config/mage_caterv1.yaml", FRAMES, device=device, seed=0,
                              dropout=0.0)
        opt = mt.make_mage_optimizer(pipe.core)
        step = mt.make_mage_train_step(pipe, opt)
        weights = {k: v.clone() for k, v in pipe.core.state_dict().items()}

        def eval_mode_loss():
            t = pipe.loss_terms(batch, train=False, posterior_noise=noise)
            t["final_loss"] = mt.train_loss(pipe, t, TRAIN_BETA, TRAIN_ALPHA)
            t["final_loss"].backward()
            return t

        with torch.backends.cudnn.flags(enabled=cudnn, allow_tf32=False):
            terms, train_launches, _ = count_launches(torch, kernels, lambda: step(
                batch, TRAIN_LR, TRAIN_BETA, TRAIN_ALPHA, posterior_noise=noise))
            train = ({k: v.item() for k, v in terms.items()},
                     {k: p.grad.cpu() for k, p in pipe.core.named_parameters()
                      if p.grad is not None})
            pipe.core.load_state_dict(weights)
            pipe.core.zero_grad(set_to_none=True)
            terms, eval_launches, _ = count_launches(torch, kernels, eval_mode_loss)
            evals = ({k: v.item() for k, v in terms.items()},
                     {k: p.grad.cpu() for k, p in pipe.core.named_parameters()
                      if p.grad is not None})
        if device == "cuda":
            log(f"f32 training check on the GPU ({run}): launches in the train step "
                f"{train_launches}, in the eval-mode loss {eval_launches}")
            expect(train_launches, {"vq_nearest": 1}, "f32 train step")
            expect(eval_launches, {"vq_nearest": 1, "axial_slot_attention": spatial_blocks(pipe)},
                   "f32 eval-mode loss")
        outs[run] = {"train": train, "eval": evals}
        if device == "cpu":  # f64 runs of both losses, to read every run against
            ids = pipe.encode_first_stage(batch["images"])
            pipe.core.double()
            f64 = {}
            for mode, train in (("train", True), ("eval", False)):
                pipe.core.load_state_dict(weights)
                pipe.core.zero_grad(set_to_none=True)
                terms = pipe.loss_terms({**batch, "latents": ids}, train=train,
                                        posterior_noise=noise.double())
                mt.train_loss(pipe, terms, TRAIN_BETA, TRAIN_ALPHA).backward()
                f64[mode] = {k: p.grad for k, p in pipe.core.named_parameters()
                             if p.grad is not None}
        log(f"f32 training check: {run} runs took {time.perf_counter() - t0:.1f} s")

    def from_f64(run, mode):
        return {k: float((g.double() - f64[mode][k]).abs().max() / f64[mode][k].abs().max())
                for k, g in outs[run][mode][1].items() if k != shift_invariant}

    for mode in ("train", "eval"):
        against = {run: from_f64(run, mode) for run in outs}
        log(f"f32 training check against an f64 CPU run ({mode} mode), largest gradient "
            f"error of its tensor's max |g|: " + ", ".join(
                f"{r} {max(against[r].values())} ({max(against[r], key=against[r].get)})"
                for r in outs))
        (terms_g, grads_g), (terms_c, grads_c) = outs["cuda"][mode], outs["cpu"][mode]
        term_err = {k: abs(terms_g[k] - terms_c[k]) / abs(terms_c[k]) for k in terms_c}
        if grads_g.keys() != grads_c.keys():
            raise AssertionError(f"{mode}: the GPU and CPU train other parameters")
        top = max(float(g.abs().max()) for g in grads_c.values())
        worst, worst_key, bad = 0.0, None, []
        for key, gc_ in grads_c.items():
            gg = grads_g[key]
            if key == shift_invariant:
                if max(float(gg.abs().max()), float(gc_.abs().max())) > 1e-6 * top:
                    raise AssertionError(f"{mode}: {key} has a gradient past rounding")
                continue
            rel = float((gg - gc_).abs().max()) / max(float(gc_.abs().max()), 1e-30)
            cpu_f64, gpu_f64 = against["cpu"][key], against["cuda"][key]
            if rel > GRAD_TOL and (cpu_f64 <= GRAD_TOL or gpu_f64 > F32_SPREAD * cpu_f64):
                bad.append((key, rel, cpu_f64, gpu_f64))
            if rel > worst:
                worst, worst_key = rel, key
        log(f"f32 GPU vs CPU training check ({mode} mode): terms {terms_c}, relative "
            f"term errors {term_err}, largest gradient error {worst} of its tensor's "
            f"max |g| ({worst_key}; from f64: CPU {against['cpu'][worst_key]}, GPU "
            f"{against['cuda'][worst_key]}), over {len(grads_c)} tensors, "
            f"{sum(v > GRAD_TOL for v in against['cpu'].values())} unsettled by f32")
        if max(term_err.values()) > TERM_RTOL or bad:
            raise AssertionError(f"{mode}: the GPU training step disagrees with the CPU "
                                 f"past f32's own spread: {bad}")


def stage1_vqvae(torch, name: str, device: str = "cuda"):
    """The first stage of ``S1_VQ[name]``'s config at its widths, random
    weights from seed 0 (the JAX package's init scales), on ``device``."""
    from mage_tpu_torch.config import load_config
    from mage_tpu_torch.models.pipeline import FirstStageVQVAE, init_weights

    params = dict(load_config(S1_VQ[name][0]).model.params.first_stage_config.params)
    params.pop("ckpt_path", None)
    model = FirstStageVQVAE.from_config(params).model
    init_weights(model, torch.Generator().manual_seed(0))
    return model.to(device)


def running_buffers(model) -> dict:
    return {k: v.clone() for k, v in model.state_dict().items()
            if "running" in k or "num_batches" in k}


def s1_stage_split(torch, model, opt, loss_fn) -> dict:
    """Device time of a train step's forward through the loss, its backward
    and the Adam step (CUDA events, median of 3 steps)."""
    runs = {"forward": [], "backward": [], "optimizer": []}
    for _ in range(3):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        model.train()
        opt.zero_grad(set_to_none=True)
        events[0].record()
        loss = loss_fn()
        events[1].record()
        loss.backward()
        events[2].record()
        opt.step()
        events[3].record()
        torch.cuda.synchronize()
        for i, name in enumerate(runs):
            runs[name].append(events[i].elapsed_time(events[i + 1]))
    return {name: statistics.median(v) for name, v in runs.items()}


def timed_steps(torch, kernels, step) -> tuple:
    """``S1_STEPS`` calls of ``step()`` between two CUDA events, launch
    counts around them -> (last result, s/step, counts, vq variants)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def steps():
        start.record()
        for _ in range(S1_STEPS):
            out = step()
        end.record()
        return out

    out, launches, routes = count_launches(torch, kernels, steps)
    return out, start.elapsed_time(end) / S1_STEPS / 1e3, launches, routes


def run_vqvae_training(torch, kernels, name: str, card: str) -> dict:
    """Stage-1 VQ-VAE training at the config's widths, f32, batch 16
    (``train_vqvae.py``'s): a warm-up, 3 timed train steps (1 vq launch
    each, the SIMT variant with codes), the stage split, 1 eval step (1
    launch) and 1 dead-code restart (2 launches), the last two leaving the
    running averages bit-equal."""
    from mage_tpu_torch.training import vqvae_trainer as vt

    config, res, channels = S1_VQ[name]
    model = stage1_vqvae(torch, name)
    opt = vt.make_optimizer(model, S1_LR)
    step = vt.make_train_step(model, opt, S1_BETA)
    gen = torch.Generator(device="cuda").manual_seed(10)
    images = torch.rand(S1_BATCH, res, res, channels, generator=gen, device="cuda") * 2 - 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warm = {k: float(v) for k, v in step(images, S1_LR).items()}
    terms, s_per_step, launches, routes = timed_steps(
        torch, kernels, lambda: step(images, S1_LR))
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"VQ-VAE {name} train: launches in {S1_STEPS} steps {launches}, vq variants {routes}")
    expect(launches, {"vq_nearest": S1_STEPS}, f"VQ-VAE {name} train steps")
    if routes != {"simt": S1_STEPS, "wgmma": 0}:
        raise AssertionError(f"VQ-VAE {name}: the f32 vq launch did not take the SIMT variant")
    stages = s1_stage_split(torch, model, opt,
                            lambda: vt.loss_terms(model, images, S1_BETA)[0])
    before = running_buffers(model)
    evals, eval_launches, _ = count_launches(torch, kernels,
                                             lambda: vt.make_eval_step(model)(images))
    n_dead, restart_launches, _ = count_launches(
        torch, kernels, lambda: vt.make_restart_dead_codes(model)(images, generator=gen))
    log(f"VQ-VAE {name}: launches in an eval step {eval_launches}, in a restart "
        f"{restart_launches}")
    expect(eval_launches, {"vq_nearest": 1}, f"VQ-VAE {name} eval step")
    expect(restart_launches, {"vq_nearest": 2}, f"VQ-VAE {name} restart")
    after = running_buffers(model)
    if not all(torch.equal(after[k], v) for k, v in before.items()):
        raise AssertionError(f"VQ-VAE {name}: the eval step or restart moved the running stats")
    values = [*warm.values(), *(float(v) for v in terms.values()),
              *(float(v) for v in evals.values())]
    if not all(math.isfinite(v) for v in values):
        raise AssertionError(f"VQ-VAE {name}: non-finite loss {values}")
    result = {"config": config, "first_stage": name, "card": card, "batch": S1_BATCH,
              "frame": [res, res, channels], "dim": model.dim,
              "K": model.codebook.embedding.weight.shape[0], "dtype": "float32",
              "s_per_step": s_per_step, "stage_ms": stages, "peak_gib": peak,
              "terms_after_warmup": warm, "terms_after_steps":
                  {k: float(v) for k, v in terms.items()},
              "eval_terms": {k: float(v) for k, v in evals.items()},
              "codes_restarted": int(n_dead)}
    log(f"VQ-VAE {name} training: " + json.dumps(result))
    return result


def run_klae_training(torch, kernels, card: str) -> dict:
    """KL-AE training at ``train_autoencoder_kl.py``'s defaults (128 px, ch
    128, ch_mult 1,2,4,4, 2 res blocks, z 4, batch 8, Adam 4.5e-6, KL weight
    1e-6), f32: a warm-up and 3 timed steps launching no kernel (train mode
    takes the plain chain), the stage split, and 1 eval step whose decoder
    launches gn_conv and gn_stats once per chain (``GN_CONV_SITES``' 28)."""
    from mage_tpu_torch.models.autoencoder_kl import AutoencoderKL
    from mage_tpu_torch.models.pipeline import init_weights
    from mage_tpu_torch.training import autoencoder_kl_trainer as kt

    model = AutoencoderKL(embed_dim=4, ch=128, ch_mult=(1, 2, 4, 4), num_res_blocks=2,
                          z_channels=4, resolution=RES)
    init_weights(model, torch.Generator().manual_seed(0))
    model.cuda()
    opt = kt.make_optimizer(model, KL_LR)
    step = kt.make_train_step(model, opt, KL_WEIGHT)
    gen = torch.Generator(device="cuda").manual_seed(12)
    images = torch.rand(KL_BATCH, RES, RES, 3, generator=gen, device="cuda") * 2 - 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warm = {k: float(v) for k, v in step(images, generator=gen).items()}
    terms, s_per_step, launches, _ = timed_steps(torch, kernels,
                                                 lambda: step(images, generator=gen))
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"KL-AE train: launches in {S1_STEPS} steps {launches}")
    expect(launches, {}, "KL-AE train steps")
    stages = s1_stage_split(torch, model, opt, lambda: kt.loss_terms(
        model, images, KL_WEIGHT, generator=gen)[0])
    eval_step = kt.make_eval_step(model)
    evals, eval_launches, _ = count_launches(torch, kernels,
                                             lambda: eval_step(images, generator=gen))
    eval_ms = time_ms(lambda: eval_step(images, generator=gen), iters=3, warmup=0)
    chains = sum(GN_CONV_SITES.values())
    log(f"KL-AE eval step: launches {eval_launches}")
    expect(eval_launches, {"gn_silu_conv3x3": chains, "gn_stats": chains}, "KL-AE eval step")
    values = [*warm.values(), *(float(v) for v in terms.values()),
              *(float(v) for v in evals.values())]
    if not all(math.isfinite(v) for v in values):
        raise AssertionError(f"KL-AE: non-finite loss {values}")
    result = {"card": card, "batch": KL_BATCH, "resolution": RES, "ch": 128,
              "ch_mult": [1, 2, 4, 4], "dtype": "float32", "s_per_step": s_per_step,
              "stage_ms": stages, "peak_gib": peak, "eval_step_ms": eval_ms,
              "terms_after_warmup": warm,
              "terms_after_steps": {k: float(v) for k, v in terms.items()},
              "eval_terms": {k: float(v) for k, v in evals.items()}}
    log("KL-AE training: " + json.dumps(result))
    return result


def check_stage1_vq(torch, vq, gen) -> dict:
    """The vq kernel at the stage-1 steps' shapes, f32 with codes (the SIMT
    variant): ids equal the plain version's, codes the rows of the ids;
    device time (CUDA-graph replays) beside the plain version's and the
    bound (f32 operations on the CUDA cores)."""
    out = {}
    for name, (n, k, d) in S1_VQ_SHAPES.items():
        z = torch.relu(torch.randn(n, d, generator=gen, device="cuda"))
        cb = torch.randn(k, d, generator=gen, device="cuda") * 0.5
        before = dict(vq.ROUTE_LAUNCHES)
        idx, codes = vq.nearest_with_codes(z, cb)
        ref, _ = vq.nearest_with_codes(z, cb, impl="torch")
        torch.cuda.synchronize()
        if vq.ROUTE_LAUNCHES["simt"] != before["simt"] + 1:
            raise AssertionError(f"vq at {(n, k, d)}: not the SIMT variant")
        mismatch = int((idx != ref).sum())
        if mismatch or not torch.equal(codes, cb[idx.long()]):
            raise AssertionError(f"vq at {(n, k, d)}: {mismatch} ids differ from plain, or "
                                 "codes are not the rows of the ids")
        bnd, by = bound_ms(2 * n * d * 4 + k * d * 4 + n * 4, 2.0 * n * k * d)
        out[name] = {"shape": [n, k, d],
                     "ms": graph_ms(torch, lambda: vq.nearest_with_codes(z, cb)),
                     "plain_ms": graph_ms(torch, lambda: vq.nearest_with_codes(
                         z, cb, impl="torch"), iters=5),
                     "bound_ms": bnd, "bound_by": by}
    log("vq at the stage-1 shapes (f32 with codes, device ms): " + json.dumps(out))
    return out


def shift_invariant_biases(model) -> set:
    """The biases of convs that feed a BatchNorm directly: it subtracts the
    shift they add, so their gradient is rounding noise."""
    from torch import nn

    keys = set()
    for name, mod in model.named_modules():
        if isinstance(mod, nn.Sequential):
            for i in range(len(mod) - 1):
                if isinstance(mod[i + 1], nn.BatchNorm2d) and mod[i].bias is not None:
                    keys.add(f"{name}.{i}.bias")
    return keys


def run_stage1_reference_check(torch, kernels) -> dict:
    """f32, TF32 off, batch 2 of 64-px frames, each VQ-VAE at its config's
    widths: one train step on the GPU (the vq kernel) against the CPU
    (plain version), both read against an f64 CPU step on the same weights.
    Loss terms within 1e-4 relative and the running statistics within 1e-5;
    every gradient within 1e-3 of its tensor's largest |g|, except where the
    f32 CPU step is itself further than that from the f64 one (f32 cannot
    settle the tensor at that level): there the GPU step must be no further
    from the f64 step than ``F32_SPREAD`` times the CPU's distance. The
    biases ``shift_invariant_biases`` names are held below 1e-5 of the
    model's largest gradient instead. The f32 steps are also run with the
    convolution libraries off (cuDNN on the GPU, oneDNN on the CPU) and
    read against f64, which shows where each library's summation order
    settles an ill-conditioned gradient."""
    from mage_tpu_torch.training import vqvae_trainer as vt

    out = {}
    for name in ("f4", "f8"):
        channels = S1_VQ[name][2]
        images = torch.rand(2, 64, 64, channels, generator=torch.Generator().manual_seed(13))
        images = images * 2 - 1
        runs = {}
        for label, device, dtype, libraries in (
                ("gpu", "cuda", torch.float32, True), ("cpu", "cpu", torch.float32, True),
                ("f64", "cpu", torch.float64, True),
                ("gpu_without_cudnn", "cuda", torch.float32, False),
                ("cpu_without_onednn", "cpu", torch.float32, False)):
            model = stage1_vqvae(torch, name, device).to(dtype)
            step = vt.make_train_step(model, vt.make_optimizer(model, S1_LR), S1_BETA)
            with torch.backends.cudnn.flags(enabled=libraries, allow_tf32=False), \
                    torch.backends.mkldnn.flags(enabled=libraries):
                terms, launches, _ = count_launches(
                    torch, kernels, lambda: step(images.to(device, dtype), S1_LR))
            if device == "cuda":
                expect(launches, {"vq_nearest": 1}, f"VQ-VAE {name} f32 check step")
            runs[label] = (
                {k: float(v) for k, v in terms.items()},
                {k: p.grad.cpu().double() for k, p in model.named_parameters()},
                {k: v.cpu().double() for k, v in running_buffers(model).items()
                 if "running" in k})
        gpu, cpu, f64 = runs["gpu"], runs["cpu"], runs["f64"]
        term_err = max(abs(gpu[0][k] - cpu[0][k]) / abs(cpu[0][k]) for k in cpu[0])
        stat_err = max((float(((gpu[2][k] - v).abs() / v.abs().clamp(min=1.0)).max())
                        for k, v in cpu[2].items()), default=0.0)
        top = max(float(g.abs().max()) for g in cpu[1].values())
        invariant = shift_invariant_biases(model)

        def rel(a, b):
            return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

        rows, failed = {}, []
        for key, g_cpu in cpu[1].items():
            g_gpu, g_f64 = gpu[1][key], f64[1][key]
            if key in invariant:
                if max(float(g_gpu.abs().max()), float(g_cpu.abs().max())) > 1e-5 * top:
                    failed.append(key)
                continue
            rows[key] = (rel(g_gpu, g_cpu), rel(g_cpu, g_f64), rel(g_gpu, g_f64))
            direct, cpu_f64, gpu_f64 = rows[key]
            if direct > GRAD_TOL and (cpu_f64 <= GRAD_TOL or gpu_f64 > F32_SPREAD * cpu_f64):
                failed.append(key)
        worst = {label: max(((r[i], k) for k, r in rows.items()))
                 for i, label in enumerate(("gpu_vs_cpu", "cpu_vs_f64", "gpu_vs_f64"))}
        for label in ("gpu_without_cudnn", "cpu_without_onednn"):
            worst[f"{label}_vs_f64"] = max((rel(runs[label][1][k], f64[1][k]), k) for k in rows)
        unsettled = sorted(k for k, r in rows.items() if r[1] > GRAD_TOL)
        out[name] = {"terms": cpu[0], "term_rel_err": term_err, "stat_err": stat_err,
                     "worst_grad_err": worst, "tensors": len(rows),
                     "shift_invariant": len(invariant), "unsettled_by_f32": len(unsettled),
                     "failed": failed}
        log(f"VQ-VAE {name} f32 GPU vs CPU train step: " + json.dumps(out[name]))
        if term_err > TERM_RTOL or stat_err > 1e-5 or failed:
            raise AssertionError(f"VQ-VAE {name}: the GPU train step disagrees with the CPU")
    return out


# ---- the cli phase -------------------------------------------------------------

# the README's Moving-MNIST chains through the port's entry points: 64 train
# and 16 test clips, so one epoch is 4 steps at the configs' batch 16
CLI_TRAIN, CLI_VAL, CLI_BATCH = 64, 16, 16
CLI_STEPS = CLI_TRAIN // CLI_BATCH
CLI_KL_BATCH = 8  # train_autoencoder_kl's default batch


class Patches:
    """Attributes of the port replaced for one phase (``_patch`` in
    ``__enter__``) and put back when it ends."""

    def __init__(self, torch):
        self.torch = torch
        self._undo = []
        self.reset()

    def reset(self) -> None:
        pass

    def _patch(self, owner, name, wrap) -> None:
        old = getattr(owner, name)
        self._undo.append((owner, name, old))
        setattr(owner, name, wrap(old))

    def __exit__(self, *exc) -> None:
        for owner, name, old in reversed(self._undo):
            setattr(owner, name, old)
        self._undo.clear()


class CliProbe(Patches):
    """Instrumentation of the cli phase, patched in for its duration: CUDA
    events around every train step (``make_train_step``,
    ``make_mage_train_step``) and ``MagePipeline.generate`` call, the host
    time the main thread waited on a loader for the batch that call took,
    and the inputs and ids of each ``MAGECore.generate_cached`` call."""

    def reset(self) -> None:
        self.steps = []  # (start event, end event, loader wait s or None)
        self.videos = []  # generate's outputs
        self.cached = []  # generate_cached's inputs, generator state and ids
        self._wait = None

    def __enter__(self) -> "CliProbe":
        import threading

        from mage_tpu_torch.data import loader
        from mage_tpu_torch.models import mage, pipeline
        from mage_tpu_torch.training import autoencoder_kl_trainer, mage_trainer, vqvae_trainer

        probe = self

        def waited(old):
            def __iter__(self_):
                it = old(self_)
                if threading.current_thread() is not threading.main_thread():
                    yield from it  # a prefetch worker's inner loader
                    return
                try:
                    while True:
                        t0 = time.perf_counter()
                        try:
                            item = next(it)
                        except StopIteration:
                            return
                        probe._wait = time.perf_counter() - t0
                        yield item
                finally:
                    it.close()
            return __iter__

        def timed_factory(old):
            def factory(*args, **kwargs):
                step = old(*args, **kwargs)
                return lambda *a, **k: probe._timed(step, a, k)
            return factory

        def generate(old):
            def wrapped(self_, batch, **kwargs):
                video = probe._timed(old, (self_, batch), kwargs)
                probe.videos.append(video)
                return video
            return wrapped

        def generate_cached(old):
            def wrapped(self_, latents0, text, speed=None, **kwargs):
                gen = kwargs.get("generator")
                state = gen.get_state().clone() if gen is not None else None
                ids = old(self_, latents0, text, speed, **kwargs)
                probe.cached.append({"latents0": latents0.clone(), "text": text.clone(),
                                     "speed": None if speed is None else speed.clone(),
                                     "state": state, "ids": ids.clone()})
                return ids
            return wrapped

        self._patch(loader.Loader, "__iter__", waited)
        self._patch(loader.PrefetchLoader, "__iter__", waited)
        self._patch(vqvae_trainer, "make_train_step", timed_factory)
        self._patch(autoencoder_kl_trainer, "make_train_step", timed_factory)
        self._patch(mage_trainer, "make_mage_train_step", timed_factory)
        self._patch(pipeline.MagePipeline, "generate", generate)
        self._patch(mage.MAGECore, "generate_cached", generate_cached)
        return self

    def _timed(self, fn, args, kwargs):
        torch = self.torch
        wait, self._wait = self._wait, None
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        self.steps.append((start, end, wait))
        return out

    def summary(self) -> dict:
        """Steps, s/step by CUDA events from the second step's start to the
        last one's end (gaps included), each step's own span, and the
        loader wait per batch, all over the steps after the first (the
        first step alone when there is one)."""
        self.torch.cuda.synchronize()
        steps = self.steps[1:] or self.steps
        spans = [s.elapsed_time(e) for s, e, _ in steps]
        waits = [w * 1e3 for _, _, w in steps if w is not None]
        s_per_step = (steps[0][0].elapsed_time(steps[-1][1]) / len(steps) / 1e3
                      if steps else None)
        return {"steps": len(self.steps), "s_per_step": s_per_step,
                "step_ms": statistics.mean(spans) if spans else None,
                "loader_wait_ms_per_batch": statistics.mean(waits) if waits else None}


def cli_run(torch, kernels, probe, label: str, fn, want: dict, steps: int, card: str):
    """One entry point's ``main(argv)`` with the launch counts read around
    it, which must be ``want``, and the train steps or ``generate`` calls
    the probe timed, which must be ``steps``; logs its line -> (fn's
    result, the line)."""
    probe.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, launches, routes = count_launches(torch, kernels, fn)
    wall = time.perf_counter() - t0
    expect(launches, want, label)
    if len(probe.steps) != steps:
        raise AssertionError(f"{label}: the probe timed {len(probe.steps)} steps, not {steps}")
    line = {"run": label, "card": card, "wall_s": wall, **probe.summary(),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": {k: v for k, v in launches.items() if v}, "vq_variants": routes}
    log("cli run: " + json.dumps(line))
    return out, line


def check_compose(torch, np, root: str) -> None:
    """``device_data.compose_frames`` over every record of the generated
    store: on the card bit-equal to the CPU's, and both bit-equal to the
    ``.mrs`` frames after /255 - 0.5."""
    from mage_tpu_torch.data import device_data as dd
    from mage_tpu_torch.data.recordio import RecordReader

    compact = dd.build_compact_single_mnist(CLI_TRAIN, CLI_VAL, seed=0)
    for split, name in (("train", "train"), ("val", "test")):
        c = compact[split]
        args = [np.repeat(c["digit"], dd.SEQ_LENGTH), c["ys"].reshape(-1), c["xs"].reshape(-1)]
        out = {}
        for device in ("cuda", "cpu"):
            bank = dd.normalize_bank(compact["bank"], device=device)
            out[device] = dd.compose_frames(bank, *(torch.as_tensor(a, device=device)
                                                    for a in args)).cpu()
        records = RecordReader(f"{root}{name}.mrs")
        want = np.stack([records[i][0] for i in range(len(records))])
        want = torch.from_numpy(want.astype(np.float32) / 255.0 - 0.5).reshape(-1, 64, 64, 1)
        for a, b, what in ((out["cuda"], out["cpu"], "the card and the CPU"),
                           (out["cpu"], want, "the CPU and the generator's records")):
            if not torch.equal(a, b):
                diff = (a - b).abs()
                raise AssertionError(
                    f"compose_frames ({split}) differs between {what}: "
                    f"{int((diff > 0).sum())} values, max {float(diff.max())}")
    log(f"compose_frames: {CLI_TRAIN + CLI_VAL} clips x {dd.SEQ_LENGTH} frames bit-equal on "
        "the card, on the CPU and in the generator's records")


def cli_config(src: str, dst: str, root: str, first_stage_ckpt: str) -> None:
    """A copy of a shipped config cut to one epoch whose validation and
    checkpoints come after its last step, on the generated data and the
    first stage just trained."""
    from mage_tpu_torch.config import load_config, save_config

    cfg = load_config(src)
    cfg.train.epoch = 1
    cfg.train.checkpoint_every = CLI_STEPS
    cfg.data.params.data_root = root
    cfg.model.params.first_stage_config.params.ckpt_path = first_stage_ckpt
    save_config(cfg, dst)


def check_cli_sample_ids(torch, capture: dict, batch_images, ckpt_dir: str) -> None:
    """The f32 sample's first-frame ids and generated ids against the same
    restored weights on the CPU (plain versions), the prior noise redrawn
    from the card generator's state at the call."""
    from mage_tpu_torch.config import instantiate_from_config, load_config

    cfg = load_config(os.path.join(ckpt_dir, "config.yaml"))
    pipe = instantiate_from_config(cfg.model, merge={"device": "cpu"})
    pipe.core.load_state_dict(torch.load(os.path.join(ckpt_dir, "model_best"),
                                         map_location="cpu", weights_only=True)["model"])
    latents0 = pipe.encode_first_stage(batch_images[:, 0:1])
    if not torch.equal(latents0, capture["latents0"].cpu()):
        raise AssertionError("cli sample: the card's first-frame ids differ from the CPU's")
    gen = torch.Generator(device="cuda")
    gen.set_state(capture["state"])
    b, _, h, w = latents0.shape
    noise = torch.randn((b, h, w, 64), generator=gen, device="cuda", dtype=torch.float32)
    ids = pipe.core.generate_cached(latents0, capture["text"].cpu(), capture["speed"].cpu(),
                                    video_noise=noise.cpu())
    same = (ids == capture["ids"].cpu()).float().mean().item()
    log(f"cli sample: f32 ids {tuple(ids.shape)} equal to the CPU's in {same:.6f} of places")
    if same != 1.0:
        raise AssertionError("cli sample: the card's f32 ids differ from the CPU's")


def check_converted_sample(torch, kernels, probe, capture: dict, sample: list, ckpt: str,
                           tmp: str, generate: dict, card: str) -> dict:
    """The trained core as a reference checkpoint (DDP's ``module.`` keys
    under ``state_dict``), converted by ``compat.convert mage`` next to the
    run's ``config.yaml`` and sampled by ``main_mage --test_model`` as the
    port-format checkpoint was: the ids must equal that f32 sample's."""
    from mage_tpu_torch.cli import main_mage
    from mage_tpu_torch.compat import convert

    core = torch.load(os.path.join(ckpt, "model_best"), map_location="cpu",
                      weights_only=True)["model"]
    ref = os.path.join(tmp, "reference_model_best.pth")
    torch.save({"state_dict": {"module." + k: v for k, v in core.items()}}, ref)
    converted = os.path.join(ckpt, "model_converted")
    convert.main(["mage", "--input", ref, "--config", os.path.join(ckpt, "config.yaml"),
                  "--output", converted])
    argv = list(sample)
    argv[argv.index("--test_model") + 1] = converted
    _, line = cli_run(torch, kernels, probe, "main_mage test (MAGE, converted)",
                      lambda: main_mage.main(argv), generate, 1, card)
    if not torch.equal(probe.cached[0]["ids"], capture["ids"]):
        raise AssertionError("converted sample: ids differ from the port checkpoint's")
    log("cli sample: a converted reference checkpoint samples the same ids")
    return line


def run_cli_phase(torch, np, kernels, card: str) -> dict:
    """The README's chains on the card through ``mage_tpu_torch.cli`` and the
    generator, in process and in a temporary directory: generate 64 + 16
    Moving-MNIST clips; compose them on the card; ``train_vqvae`` (f4, dim
    256, K 512, batch 16, 1 epoch), ``main_mage`` train on
    ``config/mage_mnist.yaml`` (full width, 4 steps, validation and
    checkpoints after the 4th) and test (2 items, f32 then ``--bf16``);
    ``train_autoencoder_kl`` (64 px, ch 64, ch_mult 1,2,4, batch 8),
    ``main_mage`` train on ``config/mage+_mnist.yaml`` (bf16, auto-beta) and
    test (1 item, naive sampler). Each run's launches must be as counted
    below; returns each run's line."""
    import importlib.util
    import tempfile

    from mage_tpu_torch.cli import main_mage, train_autoencoder_kl, train_vqvae
    from mage_tpu_torch.data.generators import mnist_single
    from mage_tpu_torch.models.autoencoder_kl import AutoencoderKL, ResnetBlock

    t_phase = time.perf_counter()
    present = {m: importlib.util.find_spec(m) is not None for m in ("PIL", "cv2", "imageio")}
    log(f"cli phase: packages {present}; the digit bank needs PIL, the stage-1 crop cv2 or "
        "PIL, the GIFs imageio or else PIL")
    tf32 = torch.backends.cudnn.allow_tf32
    lines = {}
    with tempfile.TemporaryDirectory() as tmp, CliProbe(torch) as probe:
        mnist_single.main(["--out", tmp, "--num-train", str(CLI_TRAIN), "--num-val",
                           str(CLI_VAL), "--seed", "0"])
        root = os.path.join(tmp, "mnist_single_20f_10k_")
        check_compose(torch, np, root)
        # the runs train on torch's default precision flags, as a user's do
        torch.backends.cudnn.allow_tf32 = True

        # MAGE: the f4 VQ-VAE, then stage 2 on config/mage_mnist.yaml
        stage1 = ["--data-root", root, "--dataset", "mnist", "--num-epochs", "1",
                  "--log-folder", os.path.join(tmp, "log"), "--seed", "0", "--device", "cuda"]
        models = os.path.join(tmp, "model")
        # a train step and an eval step launch vq once, so does the
        # reconstruction of the fixed test images
        _, lines["train_vqvae"] = cli_run(torch, kernels, probe, "train_vqvae", lambda: train_vqvae.main(
            stage1 + ["--output-folder", "mnist_512_256", "--batch-size", str(CLI_BATCH),
                      "--model-folder", models]),
            {"vq_nearest": CLI_STEPS + CLI_VAL // CLI_BATCH + 1}, CLI_STEPS, card)
        mage_cfg = os.path.join(tmp, "mage_mnist.yaml")
        cli_config("config/mage_mnist.yaml", mage_cfg, root,
                   os.path.join(models, "mnist_512_256", "best"))
        ckpt = os.path.join(tmp, "results", "mage_mnist")
        _, lines["main_mage train (MAGE)"] = cli_run(
            torch, kernels, probe, "main_mage train (MAGE)",
            lambda: main_mage.main(["--config", mage_cfg, "--split", "train",
                                    "--checkpoint-path", ckpt, "--device", "cuda"]),
            {"vq_nearest": CLI_STEPS + 1, "axial_slot_attention": 4}, CLI_STEPS, card)
        generate = {"vq_nearest": 1, "axial_slot_attention": 4 * FRAMES,
                    "cached_slot_attention": 2 * FRAMES}
        sample = ["--split", "test", "--test_model", os.path.join(ckpt, "model_best"),
                  "--max-test-items", "2", "--sample-batch-size", "2", "--device", "cuda"]
        torch.backends.cudnn.allow_tf32 = False  # the f32 sample is held to the CPU's ids
        done, lines["main_mage test (MAGE, f32)"] = cli_run(
            torch, kernels, probe, "main_mage test (MAGE, f32)",
            lambda: main_mage.main(sample), generate, 1, card)
        if done != 2 or len(probe.cached) != 1:
            raise AssertionError(f"cli sample: {done} items in {len(probe.cached)} calls")
        capture, video = probe.cached[0], probe.videos[0]
        check_cli_sample_ids(torch, capture, video[:, :1].cpu(), ckpt)
        lines["main_mage test (MAGE, converted)"] = check_converted_sample(
            torch, kernels, probe, capture, sample, ckpt, tmp, generate, card)
        torch.backends.cudnn.allow_tf32 = True
        done, lines["main_mage test (MAGE, bf16)"] = cli_run(
            torch, kernels, probe, "main_mage test (MAGE, bf16)",
            lambda: main_mage.main(sample + ["--bf16"]), generate, 1, card)
        video = probe.videos[0].float()
        if not (done == 2 and torch.isfinite(video).all() and video.abs().max() <= 1.0):
            raise AssertionError("cli sample (bf16): frames not finite or outside [-1, 1]")
        if lines["main_mage test (MAGE, bf16)"]["vq_variants"]["wgmma"]:
            raise AssertionError("cli sample (bf16): the f32 first stage's vq took bf16's variant")
        gifs = len(os.listdir(os.path.join(ckpt, "videos")))

        # MAGE+: the f4 KL-AE, then stage 2 on config/mage+_mnist.yaml
        kl = AutoencoderKL(ch=64, ch_mult=(1, 2, 4), in_channels=1, out_ch=1, resolution=64)
        chains = 2 * sum(isinstance(m, ResnetBlock) for m in kl.decoder.modules())
        del kl
        _, lines["train_autoencoder_kl"] = cli_run(
            torch, kernels, probe, "train_autoencoder_kl", lambda: train_autoencoder_kl.main(
                stage1 + ["--resolution", "64", "--ch", "64", "--ch-mult", "1", "2", "4",
                          "--output-folder", "kl_f4_mnist", "--model-folder",
                          os.path.join(tmp, "autoencoders")]),
            {"gn_silu_conv3x3": chains * (CLI_VAL // CLI_KL_BATCH),
             "gn_stats": chains * (CLI_VAL // CLI_KL_BATCH)}, CLI_TRAIN // CLI_KL_BATCH, card)
        magep_cfg = os.path.join(tmp, "mage+_mnist.yaml")
        cli_config("config/mage+_mnist.yaml", magep_cfg, root,
                   os.path.join(tmp, "autoencoders", "kl_f4_mnist", "best"))
        ckpt = os.path.join(tmp, "results", "mage+_mnist")
        _, lines["main_mage train (MAGE+)"] = cli_run(
            torch, kernels, probe, "main_mage train (MAGE+)",
            lambda: main_mage.main(["--config", magep_cfg, "--split", "train",
                                    "--checkpoint-path", ckpt, "--device", "cuda"]),
            {"axial_slot_attention": 4}, CLI_STEPS, card)
        # the naive sampler (MAGE+'s default): 4 spatial blocks per step over
        # 15 steps, then one decode chunk of the 15 generated frames
        done, lines["main_mage test (MAGE+)"] = cli_run(
            torch, kernels, probe, "main_mage test (MAGE+)",
            lambda: main_mage.main(["--split", "test", "--test_model",
                                    os.path.join(ckpt, "model_best"), "--max-test-items",
                                    "1", "--device", "cuda"]),
            {"axial_slot_attention": 4 * (FRAMES - 1), "gn_silu_conv3x3": chains,
             "gn_stats": chains}, 1, card)
        if not (done == 1 and torch.isfinite(probe.videos[0]).all()):
            raise AssertionError("cli sample (MAGE+): frames not finite")
        gifs += len(os.listdir(os.path.join(ckpt, "videos")))
    torch.backends.cudnn.allow_tf32 = tf32
    log(f"cli phase took {time.perf_counter() - t_phase:.1f} s ({gifs} GIFs written)")
    return lines


# ---- the kv-quant phase ----------------------------------------------------------

KV_QUANTS = (None, "int8", "int4")


def cache_bytes(torch, pipe, batch: int, dtype) -> int:
    """Bytes of the temporal K/V caches (and scales) ``generate_cached``
    allocates at ``batch``; int4 codes are stored in int8, so they take
    int8's bytes."""
    cache = pipe.core.generate_model.init_cache(batch, 16, 16, dtype, "cuda")
    return sum(t.numel() * t.element_size() for entry in cache.values() for t in entry)


def run_kvquant_phase(torch, np, build_pipeline, kernels, card: str) -> dict:
    """The cached sampler over a quantized K/V cache: MAGE on the main
    path's shapes (``config/mage_caterv1.yaml``, batch 32, 16 frames, bf16,
    flat route) with ``kv_quant`` None, "int8" and "int4" on the same
    weights: launches around one generate (vq 1, axial 64, cached 32 for
    None and 0 for the quantized caches, whose attention is plain PyTorch as
    in JAX), frames/s (median of 3), AR core ms, peak GiB, the caches'
    bytes, and the share of generated ids equal to the unquantized run's
    (information, not a check). Then, f32, for int8 and int4: one slot's
    codes and scales on the card bit-equal to the CPU's; the quantized
    attention over one cache at the main path's shapes
    (``check_quant_attention``) and one quantized ``decode_slot`` there
    (``check_quant_decode_slot``) on the card against the CPU; and, at
    batch 2, the card's generated
    ids no further from an f64 CPU run than the CPU's f32 ids are (below),
    with the shares of ids printed."""
    from mage_tpu_torch.ops import cached_attention as ca

    t_phase = time.perf_counter()
    pipe = build_pipeline("config/mage_caterv1.yaml", FRAMES, device="cuda", seed=0)
    pipe.to(dtype=torch.bfloat16)
    batch = make_batch(np, BATCH, pipe.core.text_encoder.positions.num_embeddings)
    gen = torch.Generator(device="cuda")
    first = torch.from_numpy(batch["images"][:, :1]).to("cuda", torch.bfloat16)
    text = torch.from_numpy(batch["text"]).cuda()
    speed = torch.from_numpy(batch["speed"]).to("cuda", torch.bfloat16)
    lat0 = pipe.first_stage.encode(first)
    results, ids = {}, {}
    for kv in KV_QUANTS:
        pipe.core.generate_model.kv_quant = kv
        pipe.generate(batch, generator=gen.manual_seed(1), cached=True)  # warm-up
        _, launches, _ = count_launches(
            torch, kernels, lambda: pipe.generate(batch, generator=gen.manual_seed(1),
                                                  cached=True))
        want = {"vq_nearest": 1, "axial_slot_attention": 4 * FRAMES,
                "cached_slot_attention": 0 if kv else 2 * FRAMES}
        expect(launches, want, f"generate with kv_quant={kv}")
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            video = pipe.generate(batch, generator=gen.manual_seed(2 + i), cached=True)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        if not bool(torch.isfinite(video.float()).all()):
            raise AssertionError(f"kv_quant={kv}: non-finite frames")
        peak = torch.cuda.max_memory_allocated() / 2**30
        ar = []
        for _ in range(3):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = pipe.core.generate_cached(lat0, text, speed, generator=gen.manual_seed(1))
            end.record()
            torch.cuda.synchronize()
            ar.append(start.elapsed_time(end))
        ids[kv] = out
        results[str(kv)] = {
            "card": card, "kv_quant": kv, "launches": {k: v for k, v in launches.items() if v},
            "generated_frames_per_s": BATCH * (FRAMES - 1) / statistics.median(times),
            "generate_s": times, "ar_core_ms": statistics.median(ar), "ar_core_ms_runs": ar,
            "peak_gib": peak, "cache_bytes": cache_bytes(torch, pipe, BATCH, torch.bfloat16),
            "ids_equal_to_unquantized": float((out == ids[None]).float().mean()),
        }
        log("kv-quant run: " + json.dumps(results[str(kv)]))

    # f32: the card against the CPU. The quantizer rounds, so an ulp of
    # difference in a K/V projection can move a code by one step, and a
    # free-running AR generation amplifies that: on the CPU alone f32 and
    # f64 share only about 99% (int8) and 96% (int4) of their ids, against
    # 100% unquantized. So the deterministic holds are one slot's codes (bit
    # for bit on the same K/V), the attention over one cache and one
    # teacher-forced decode_slot, at the main path's shapes;
    # at batch 2 from the same first-frame ids, the card's generated ids are
    # only held to be no further from an f64 CPU run than the CPU's f32 are
    # (twice its distance plus 0.005 of the ids).
    small = make_batch(np, 2, 32, seed=3)
    noise = torch.randn(2, 16, 16, 64, generator=torch.Generator().manual_seed(4))
    pipes = {d: build_pipeline("config/mage_caterv1.yaml", FRAMES, device=d, seed=0)
             for d in ("cuda", "cpu")}
    lat0_c = pipes["cpu"].first_stage.encode(torch.from_numpy(small["images"][:, :1]))
    kv_x = torch.randn(CA_N, CA_D, generator=gen.manual_seed(5), device="cuda") * 3
    for kv in ("int8", "int4"):
        bits = 8 if kv == "int8" else 4
        codes, scale = ca.quantize_kv_slot(kv_x, CA_D // 32, bits)
        codes_c, scale_c = ca.quantize_kv_slot(kv_x.cpu(), CA_D // 32, bits)
        if not (torch.equal(codes.cpu(), codes_c) and torch.equal(scale.cpu(), scale_c)):
            raise AssertionError(f"kv_quant={kv}: the card's codes differ from the CPU's")
        check_quant_attention(torch, ca, kv, gen.manual_seed(6))
        check_quant_decode_slot(torch, pipes, kv)
        out = {}
        for name, d, dtype in (("cuda", "cuda", torch.float32), ("cpu", "cpu", torch.float32),
                               ("cpu_f64", "cpu", torch.float64)):
            p = pipes[d]
            p.core.generate_model.kv_quant = kv
            p.core.to(dtype)
            out[name] = p.core.generate_cached(
                lat0_c.to(d), torch.from_numpy(small["text"]).to(d),
                torch.from_numpy(small["speed"]).to(d, dtype),
                video_noise=noise.to(d, dtype)).cpu()
        pipes["cpu"].core.float()
        agree = {f"{a}-{b}": float((out[a] == out[b]).float().mean())
                 for a, b in (("cuda", "cpu"), ("cuda", "cpu_f64"), ("cpu", "cpu_f64"))}
        log(f"kv_quant={kv} f32 at batch 2, generated ids shared: {json.dumps(agree)}; "
            f"the codes of one slot bit-equal")
        card_off, cpu_off = 1 - agree["cuda-cpu_f64"], 1 - agree["cpu-cpu_f64"]
        if card_off > 2 * cpu_off + 0.005:
            raise AssertionError(f"kv_quant={kv}: the card is further from f64 than f32 is")
    log(f"kv-quant phase took {time.perf_counter() - t_phase:.1f} s")
    return results


def check_quant_attention(torch, ca, kv: str, gen) -> None:
    """``cached_slot_attention_quant`` at the main path's shapes (8192 tokens,
    16 slots, width 512, 16 heads) over one fixed filled cache, f32, on the
    card and on the CPU from the same codes and scales (TF32 off), at the
    first, a middle and the last slot: within ``F32_TOL``, as the cached
    kernel's f32 check. The deterministic hold of the quantized attention
    that a free-running generation cannot give."""
    bits = 8 if kv == "int8" else 4
    heads = CA_D // 32
    q = torch.randn(CA_N, CA_D, generator=gen, device="cuda")
    slots = [ca.quantize_kv_slot(torch.randn(CA_N, CA_D, generator=gen, device="cuda") * 3,
                                 heads, bits) for _ in range(2 * CA_L)]
    ck, cv = (torch.stack([c for c, _ in part]) for part in (slots[:CA_L], slots[CA_L:]))
    sk, sv = (torch.cat([s_ for _, s_ in part]) for part in (slots[:CA_L], slots[CA_L:]))
    err = 0.0
    for pos in (0, CA_L // 2, CA_L - 1):
        got = ca.cached_slot_attention_quant(q, ck, cv, sk, sv, pos, heads).cpu()
        want = ca.cached_slot_attention_quant(q.cpu(), ck.cpu(), cv.cpu(), sk.cpu(),
                                              sv.cpu(), pos, heads)
        e = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=F32_TOL, atol=F32_TOL):
            raise AssertionError(f"kv_quant={kv}: the quantized attention at pos {pos} on "
                                 f"the card differs from the CPU's by {e}")
        err = max(err, e)
    log(f"kv_quant={kv} quantized attention at ({CA_N}, {CA_L}, {CA_D}), f32, card against "
        f"CPU on one cache: max abs diff {err}")


def check_quant_decode_slot(torch, pipes: dict, kv: str) -> None:
    """One quantized ``decode_slot`` at the main path's shapes (batch 32,
    16 x 16 latents, ``config/mage_caterv1.yaml``'s full-width decoder), the
    anchor at slot 0 and a frame at slot 1, in f32 on the CPU and then on
    the card from the same weights and inputs (TF32 off). A code is a
    rounding, so an ulp of difference in a K or V value can flip it by a
    step, and the later blocks would carry the flip; so the card's run is
    teacher-forced: each of its ``quantize_kv_slot`` calls is held to the
    CPU's on the same call (codes equal but for flips in at most 1e-4 of
    them, none by more than one step; scales within ``F32_TOL`` relative),
    and the cache takes the CPU's codes and scales. The card's trunk is then
    held within 1e-4 of the CPU's largest |trunk|."""
    from mage_tpu_torch.models import layers

    g = torch.Generator().manual_seed(6)
    dec = pipes["cpu"].core.generate_model
    anchor = torch.randn(BATCH, 16, 16, dec.context_linear.in_features, generator=g)
    slot = torch.randn(BATCH, 16, 16, dec.in_linear.in_features, generator=g)
    real = layers.quantize_kv_slot
    cpu_calls, calls = [], []

    def recorded(x, n_head, bits=8):
        cpu_calls.append(real(x, n_head, bits))
        return cpu_calls[-1]

    def forced(x, n_head, bits=8):
        codes, scale = real(x, n_head, bits)
        codes_c, scale_c = cpu_calls[len(calls)]
        calls.append({
            "flipped": float((codes.cpu() != codes_c).float().mean()),
            "steps": float((codes.cpu().int() - codes_c.int()).abs().max()),
            "scale_rel": float(((scale.cpu() - scale_c).abs() / scale_c).max())})
        return codes_c.to(x.device), scale_c.to(x.device)

    trunks = {}
    try:
        for d, quantize in (("cpu", recorded), ("cuda", forced)):
            layers.quantize_kv_slot = quantize
            dec = pipes[d].core.float().eval().generate_model
            dec.kv_quant = kv
            cache = dec.init_cache(BATCH, 16, 16, torch.float32, d)
            with torch.no_grad():
                dec.decode_slot(anchor.to(d), 0, cache, is_anchor=True)
                trunks[d] = dec.decode_slot(slot.to(d), 1, cache).cpu()
            del cache
    finally:
        layers.quantize_kv_slot = real
    worst = {key: max(c[key] for c in calls) for key in ("flipped", "steps", "scale_rel")}
    trunk_err = float((trunks["cuda"] - trunks["cpu"]).abs().max())
    trunk_max = float(trunks["cpu"].abs().max())
    log(f"kv_quant={kv} decode_slot at batch {BATCH}, f32, card against CPU (teacher-forced "
        f"codes): {len(calls)} quantizations, worst {json.dumps(worst)}; max |trunk diff| "
        f"{trunk_err} (max |trunk| {trunk_max})")
    if len(calls) != len(cpu_calls) or worst["flipped"] > 1e-4 or worst["steps"] > 1 \
            or worst["scale_rel"] > F32_TOL or trunk_err > 1e-4 * trunk_max:
        raise AssertionError(f"kv_quant={kv}: decode_slot on the card differs from the CPU")


# ---- the e2e phase ---------------------------------------------------------------


class E2eProbe(Patches):
    """Instrumentation of the e2e and evals phases, patched in for their
    duration: CUDA events around every stage-1 step (``vqvae_trainer`` and
    ``autoencoder_kl_trainer`` step factories), stage-2 step
    (``training.e2e.make_mage_train_step``) and extractor step
    (``cli.train_fvd_extractor.make_train_step``), the host time of
    ``training.e2e.materialize`` and ``log_fvd`` (device synchronized), and
    the kernel launches the chains make: the inputs and output of the first
    launch of each distinct shape (for cached attention, of each of the
    first, middle and last slot), which ``hold`` then holds against the
    kernels' plain versions."""

    def reset(self) -> None:
        self.steps = {"stage1": [], "stage2": [], "extractor": []}
        self.host = {"materialize_s": 0.0, "fvd_s": 0.0}
        self.held = {}  # (kernel, shapes...) -> (inputs, output)

    def _keep(self, key, inputs, output) -> None:
        if key not in self.held:
            self.held[key] = tuple(
                t.detach().clone() if isinstance(t, self.torch.Tensor) else t
                for t in (*inputs, *output))

    def __enter__(self) -> "E2eProbe":
        from mage_tpu_torch.cli import train_fvd_extractor
        from mage_tpu_torch.models import autoencoder_kl, layers
        from mage_tpu_torch.ops import vq
        from mage_tpu_torch.training import autoencoder_kl_trainer, e2e, vqvae_trainer

        probe, torch = self, self.torch

        def launches(impl, x) -> bool:
            return impl == "auto" and x.is_cuda

        def nearest(old):  # every vq entry (ids only, with codes, straight-through)
            def fn(z, codebook, impl, with_codes):
                idx, codes = old(z, codebook, impl, with_codes)
                if launches(impl, z):
                    z_flat = z.reshape(-1, z.shape[-1])
                    probe._keep(("vq_nearest", tuple(z_flat.shape), z.dtype,
                                 tuple(codebook.shape), with_codes),
                                (z_flat, codebook), (idx, codes))
                return idx, codes
            return fn

        def gn_conv(old):
            def fn(x, gamma, beta, weight, bias, *, groups=32, eps=1e-6, impl="auto"):
                out = old(x, gamma, beta, weight, bias, groups=groups, eps=eps, impl=impl)
                if launches(impl, x):
                    probe._keep(("gn_silu_conv3x3", tuple(x.shape), x.dtype,
                                 tuple(weight.shape), groups, eps),
                                (x, gamma, beta, weight, bias, groups, eps), (out,))
                return out
            return fn

        def axial(old):
            def fn(q, k, v, n_head, *, impl="auto"):
                out = old(q, k, v, n_head, impl=impl)
                if launches(impl, q):
                    probe._keep(("axial_slot_attention", tuple(q.shape), q.dtype, n_head),
                                (q, k, v, n_head), (out,))
                return out
            return fn

        def cached(old):
            def fn(q, cache_k, cache_v, pos, n_head, *, impl="auto"):
                out = old(q, cache_k, cache_v, pos, n_head, impl=impl)
                length = cache_k.shape[0]
                if launches(impl, q) and int(pos) in (0, length // 2, length - 1):
                    probe._keep(("cached_slot_attention", tuple(cache_k.shape), q.dtype,
                                 n_head, int(pos)),
                                (q, cache_k, cache_v, int(pos), n_head), (out,))
                return out
            return fn

        def timed_factory(stage):
            def wrap(old):
                def factory(*args, **kwargs):
                    step = old(*args, **kwargs)

                    def timed(*a, **k):
                        start = torch.cuda.Event(enable_timing=True)
                        end = torch.cuda.Event(enable_timing=True)
                        start.record()
                        out = step(*a, **k)
                        end.record()
                        probe.steps[stage].append((start, end))
                        return out
                    return timed
                return factory
            return wrap

        def host_timed(key):
            def wrap(old):
                def fn(*args, **kwargs):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = old(*args, **kwargs)
                    torch.cuda.synchronize()
                    probe.host[key] += time.perf_counter() - t0
                    return out
                return fn
            return wrap

        self._patch(vqvae_trainer, "make_train_step", timed_factory("stage1"))
        self._patch(autoencoder_kl_trainer, "make_train_step", timed_factory("stage1"))
        self._patch(e2e, "make_mage_train_step", timed_factory("stage2"))
        self._patch(train_fvd_extractor, "make_train_step", timed_factory("extractor"))
        self._patch(e2e, "materialize", host_timed("materialize_s"))
        self._patch(e2e, "log_fvd", host_timed("fvd_s"))
        self._patch(vq, "_nearest", nearest)
        self._patch(autoencoder_kl, "gn_silu_conv3x3", gn_conv)
        self._patch(layers, "axial_slot_attention", axial)
        self._patch(layers, "cached_slot_attention", cached)
        return self

    def hold(self) -> dict:
        """Each kept launch against its kernel's plain version on the same
        inputs (TF32 off), at the limits of the kernel checks above:
        attention f32 within ``F32_TOL``, bf16 within one rounding step;
        vq ids equal but for near-ties (two distances within 1e-5 of the
        row's scale) on at most 1e-3 of the rows, codes the rows of the ids;
        gn_stats within 1e-5 relative of ``gn_affine_rows`` and gn_conv on
        those rows within ``F32_TOL`` of its largest output in f32, one
        rounding step plus ``GN_BF16_ATOL`` in bf16 (as ``check_gn_conv``).
        -> {kernel: {"shapes": n, "max_abs_err": e}}; raises on any miss."""
        from mage_tpu_torch.ops import axial_attention as ax
        from mage_tpu_torch.ops import cached_attention as ca
        from mage_tpu_torch.ops import gn_conv as gc
        from mage_tpu_torch.ops import vq

        torch = self.torch
        errs = {}

        def note(name, key, err):
            log(f"e2e hold {name} {key[1:]}: max |kernel - plain| {err}")
            entry = errs.setdefault(name, {"shapes": 0, "max_abs_err": 0.0})
            entry["shapes"] += 1
            entry["max_abs_err"] = max(entry["max_abs_err"], err)

        def close(got, want, what):
            tol = (F32_TOL, F32_TOL) if got.dtype == torch.float32 else (BF16_RTOL, 1e-5)
            got, want = got.float(), want.float()
            if not torch.allclose(got, want, rtol=tol[0], atol=tol[1]):
                raise AssertionError(f"e2e {what}: max abs err "
                                     f"{float((got - want).abs().max())}")
            return float((got - want).abs().max())

        matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            with torch.no_grad():
                for key, held in self.held.items():
                    name = key[0]
                    if name == "axial_slot_attention":
                        q, k, v, n_head, got = held
                        want = ax.axial_slot_attention(q, k, v, n_head, impl="torch")
                        note(name, key, close(got, want, key))
                    elif name == "cached_slot_attention":
                        q, ck, cv, pos, n_head, got = held
                        want = ca.cached_slot_attention(q, ck, cv, pos, n_head, impl="torch")
                        note(name, key, close(got, want, key))
                    elif name == "vq_nearest":
                        z, cb, idx, codes = held
                        ref_idx, ref_codes = vq._vq_plain(z, cb)
                        rows = (idx != ref_idx).nonzero().flatten()
                        zd, cbd = z[rows].double(), cb.double()
                        dist = (cbd * cbd).sum(1)[None] - 2 * zd @ cbd.T
                        r = torch.arange(len(rows), device=z.device)
                        gap = (dist[r, idx[rows].long()] - dist[r, ref_idx[rows].long()]).abs()
                        if len(rows) > max(1, z.shape[0] * 1e-3) or bool(
                                (gap > 1e-5 * dist.abs().amax(1)).any()):
                            raise AssertionError(f"e2e {key}: {len(rows)} ids differ, not "
                                                 f"all near-ties")
                        err = 0.0
                        if codes is not None:
                            if not torch.equal(codes, cb[idx.long()]):
                                raise AssertionError(f"e2e {key}: codes are not the rows "
                                                     f"of the ids")
                            err = float((codes.float() - ref_codes.float()).abs().max())
                        note(name, key, err)
                    else:
                        x, gamma, beta, weight, bias, groups, eps, got = held
                        a, b = gc.gn_stats(x, gamma, beta, groups=groups, eps=eps)
                        wa, wb = gc.gn_stats(x, gamma, beta, groups=groups, eps=eps,
                                             impl="torch")
                        stats_err = 0.0
                        for g_, w_ in ((a, wa), (b, wb)):
                            e = float((g_ - w_).abs().max())
                            if not torch.allclose(g_, w_, rtol=1e-5,
                                                  atol=1e-5 * float(w_.abs().max())):
                                raise AssertionError(f"e2e gn_stats {key[1:]}: max abs "
                                                     f"err {e}")
                            stats_err = max(stats_err, e)
                        note("gn_stats", key, stats_err)
                        want = gc.silu_conv3x3_rows(x, a, b, weight, bias).float()
                        got = got.float()
                        e = float((got - want).abs().max())
                        ok = (e <= F32_TOL * float(want.abs().max()) if x.dtype == torch.float32
                              else torch.allclose(got, want, rtol=BF16_RTOL, atol=GN_BF16_ATOL))
                        if not ok:
                            raise AssertionError(f"e2e {key}: max abs err {e}")
                        note(name, key, e)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul
            torch.backends.cudnn.allow_tf32 = cudnn
        self.held.clear()
        return errs

    def summary(self) -> dict:
        """Steps and s/step per stage by CUDA events from the second step's
        start to the last one's end (the first step alone when there is
        one), and the host seconds."""
        self.torch.cuda.synchronize()
        out = dict(self.host)
        for stage, steps in self.steps.items():
            timed = steps[1:] or steps
            out[f"{stage}_steps"] = len(steps)
            out[f"{stage}_s_per_step"] = (timed[0][0].elapsed_time(timed[-1][1]) / len(timed)
                                          / 1e3 if timed else None)
        return out


# the cuts of every chain: a few clips, one epoch per stage, 4 steps a stage
# (one chunk), 8 eval videos (16 clips for the discrete MNIST chains'
# train-split eval), one GIF, 2 diversity draws; widths, configs and
# batches are the drivers' defaults
E2E_CUTS = ["--stage2-epochs", "1", "--chunk", "4", "--gifs", "1", "--eval-videos", "8",
            "--device", "cuda"]
E2E_VQ_CUTS = E2E_CUTS + ["--stage1-epochs", "1"]
E2E_KL_CUTS = E2E_CUTS + ["--ae-epochs", "1", "--diversity-samples", "2"]


def e2e_chains(kl_chains: dict) -> list:
    """(name, module, argv, predicted launches, phases) of the five chains.
    The counts follow the code: a VQ-VAE train step and an eval-mode encode
    launch vq once each (stage 1: 4 steps and the val recon at epoch 0, plus
    the motion frame for CATER, and the final one); materialize encodes
    ceil(clips / chunk) chunks of each split; a stage-2 train step runs no
    kernel (train mode) and the eval step 4 axial; a cached generate of L
    frames launches 4L axial and 2L cached, a naive one 4(L-1) axial; a
    KL-AE decode launches gn_conv and gn_stats once per decoder chain
    (``kl_chains``) per call of at most 96 frames. MNIST chains have L=16,
    CATER chains L=10."""
    from mage_tpu_torch.cli import (train_cater_e2e, train_cater_kl_e2e, train_mnist2_e2e,
                                    train_mnist_e2e, train_mnist_kl_e2e)

    def cdiv(a, b):
        return -(-a // b)

    vq_mnist = 4 + 2 + cdiv(64, 50) + cdiv(16, 50)
    mnist = {"vq_nearest": vq_mnist, "axial_slot_attention": 4 + 2 * 64,
             "cached_slot_attention": 2 * 32}
    c = kl_chains["f4"]
    decode = c * cdiv(8 * 15, 96)  # 8 videos x 15 generated frames
    mnist_kl = {"axial_slot_attention": 4 + 64 + 60 + 2 * 64,
                "cached_slot_attention": 32 + 2 * 32,
                "gn_silu_conv3x3": 2 * c + 4 * decode + c * cdiv(8 * 16, 96)}
    mnist_kl["gn_stats"] = mnist_kl["gn_silu_conv3x3"]
    cater = {"vq_nearest": 4 + 3 + cdiv(16, 5) + cdiv(8, 5), "axial_slot_attention": 4 + 40,
             "cached_slot_attention": 20}
    c = kl_chains["f8"]
    decode = c * cdiv(8 * 9, 96)
    cater_kl = {"axial_slot_attention": 4 + 40 + 36 + 2 * 40,
                "cached_slot_attention": 20 + 2 * 20,
                "gn_silu_conv3x3": 2 * c + 4 * decode + c * cdiv(8 * 10, 96)}
    cater_kl["gn_stats"] = cater_kl["gn_silu_conv3x3"]
    mnist_clips = ["--num-train", "64", "--num-val", "16"]
    return [
        ("train_mnist_e2e", train_mnist_e2e, E2E_VQ_CUTS + mnist_clips, mnist,
         ["stage1", "stage1_final", "latents", "stage2", "generation_val",
          "generation_train"]),
        ("train_mnist2_e2e", train_mnist2_e2e, E2E_VQ_CUTS + mnist_clips + ["--bf16"], mnist,
         ["stage1", "stage1_final", "latents", "stage2", "generation_val", "fvd_val",
          "generation_train", "fvd_train"]),
        ("train_cater_e2e", train_cater_e2e,
         E2E_VQ_CUTS + ["--num-train", "16", "--num-val", "8", "--dataset", "caterv1",
                        "--bf16"], cater,
         ["stage1", "stage1_final", "latents", "stage2", "generation_val", "fvd_val"]),
        ("train_mnist_kl_e2e", train_mnist_kl_e2e, E2E_KL_CUTS + mnist_clips, mnist_kl,
         ["klae", "klae_final", "moments", "stage2", "samplers_val", "diversity_val",
          "fvd_val"]),
        ("train_cater_kl_e2e", train_cater_kl_e2e,
         E2E_KL_CUTS + ["--num-train", "16", "--num-val", "8"], cater_kl,
         ["klae", "klae_final", "moments", "stage2", "samplers_val", "diversity_val",
          "generation_val", "fvd_val"]),
    ]


def run_e2e_phase(torch, kernels, card: str) -> dict:
    """The five e2e chains through their entry points
    (``mage_tpu_torch.cli.train_*_e2e.main``), in process and in a
    temporary directory, at their default widths with the cuts of
    ``E2E_CUTS`` (printed): each chain's launches must be the ones
    ``e2e_chains`` predicts, every kernel it launched must hold against its
    plain version at each shape the chain gave it (``E2eProbe.hold``), its
    stages must take their 4 timed steps, and its ``e2e_metrics.json`` must
    hold its phases in order with finite numbers. A line per chain gives
    wall s, the host seconds up to each of its records, stage-1 and stage-2
    s/step (CUDA events), materialize s, the FVD's s on the card
    (random-init I3D), peak GiB and the launches. Then the evals phase
    (``run_evals_phase``) on the runs of ``EVAL_RUNS``, in the same
    directory and under the same probe -> (the chains' lines, the evals'
    lines)."""
    import tempfile

    from mage_tpu_torch.models.autoencoder_kl import AutoencoderKL, ResnetBlock

    t_phase = time.perf_counter()
    kl_chains = {}
    for name, mult in (("f4", (1, 2, 4)), ("f8", (1, 2, 4, 4))):
        ae = AutoencoderKL(ch=32, ch_mult=mult)
        kl_chains[name] = 2 * sum(isinstance(m, ResnetBlock) for m in ae.decoder.modules())
    log(f"e2e phase: cuts {E2E_CUTS}, VQ chains {E2E_VQ_CUTS[len(E2E_CUTS):]}, KL chains "
        f"{E2E_KL_CUTS[len(E2E_CUTS):]}, clips per chain as listed; decoder chains {kl_chains}")
    lines = {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # torch's default, as a user's run gets it
    with tempfile.TemporaryDirectory() as tmp, E2eProbe(torch) as probe:
        for name, module, argv, want, phases in e2e_chains(kl_chains):
            out_dir = os.path.join(tmp, name)
            probe.reset()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0, start = time.perf_counter(), time.time()
            _, launches, routes = count_launches(
                torch, kernels, lambda: module.main(argv + ["--out", out_dir]))
            wall = time.perf_counter() - t0
            expect(launches, want, name)
            held = probe.hold()
            if set(held) != {k for k, n in launches.items() if n}:
                raise AssertionError(f"{name}: held {sorted(held)}, launched {launches}")
            summary = probe.summary()
            if summary["stage1_steps"] != 4 or summary["stage2_steps"] != 4:
                raise AssertionError(f"{name}: steps {summary}")
            with open(os.path.join(out_dir, "e2e_metrics.json")) as fp:
                rows = [json.loads(line) for line in fp]
            if [r["phase"] for r in rows] != phases:
                raise AssertionError(f"{name}: phases {[r['phase'] for r in rows]}")
            bad = [(r["phase"], k) for r in rows for k, v in r.items()
                   if isinstance(v, float) and not math.isfinite(v)]
            if bad:
                raise AssertionError(f"{name}: non-finite metrics {bad}")
            # host seconds up to each record: data and set-up, then each phase
            marks = [start] + [r["time"] for r in rows]
            phase_s = {r["phase"]: b - a for r, a, b in zip(rows, marks, marks[1:])}
            line = {"run": name, "card": card, "argv": argv, "wall_s": wall, **summary,
                    "phase_s": phase_s,
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                    "launches": {k: v for k, v in launches.items() if v}, "vq_variants": routes,
                    "held": held,
                    "metrics": {r["phase"]: {k: v for k, v in r.items()
                                             if k not in ("phase", "time", "extractor")}
                                for r in rows}}
            log("e2e run: " + json.dumps(line))
            lines[name] = line
            if name not in EVAL_RUNS:  # a full-width chain's checkpoints take gigabytes
                shutil.rmtree(out_dir)
        log(f"e2e phase took {time.perf_counter() - t_phase:.1f} s")
        evals = run_evals_phase(torch, kernels, card, tmp, probe)
    torch.backends.cudnn.allow_tf32 = tf32
    return lines, evals


# ---- the evals phase -----------------------------------------------------------

# the chains' runs the evals read (kept by the e2e phase until the evals end)
EVAL_RUNS = ("train_mnist_e2e", "train_cater_e2e")
# the extractor's cuts: 16 + 8 clips, one epoch of 2 steps (batch 8), 8
# calibration clips; CATER at its full width (128 px, 10 frames), MNIST 64 px
EXTRACTOR_CUTS = ["--num-train", "16", "--num-val", "8", "--epochs", "1", "--chunk", "2",
                  "--calib-videos", "8", "--device", "cuda"]


def evals_steps(tmp: str) -> list:
    """(label, entry point, argv, predicted launches) of the evals phase. The
    extractor runs no kernel (I3D is cuDNN convs). A cached generate of L
    frames launches 4L axial and 2L cached; an eval's vq launches are its
    encodes: ``eval_fvd_e2e`` materializes the 16 val clips in one chunk (1),
    ``eval_speed_control`` encodes the first frames and then every ground-
    truth frame of the sweep for its ceiling (2), ``eval_speed_control_cater``
    the first frames (1). MNIST runs have L=16, CATER L=10."""
    from mage_tpu_torch.cli import (eval_fvd_e2e, eval_speed_control,
                                    eval_speed_control_cater, train_fvd_extractor)

    mnist_run = os.path.join(tmp, "train_mnist_e2e")
    mnist_data = ["--num-train", "64", "--num-val", "16"]  # the chain's clips
    generate = {"axial_slot_attention": 4 * 16, "cached_slot_attention": 2 * 16}
    return [
        ("train_fvd_extractor caterv2", train_fvd_extractor.main,
         ["--dataset", "caterv2", "--out", os.path.join(tmp, "fvdx_cater")] + EXTRACTOR_CUTS,
         {}),
        ("train_fvd_extractor mnist", train_fvd_extractor.main,
         ["--dataset", "mnist", "--out", os.path.join(tmp, "fvdx_mnist")] + EXTRACTOR_CUTS,
         {}),
        ("eval_fvd_e2e", eval_fvd_e2e.main,
         ["--run", mnist_run, "--videos", "8", "--fvd-extractor",
          os.path.join(tmp, "fvdx_mnist"), "--out", os.path.join(tmp, "fvd_e2e.json"),
          "--device", "cuda"] + mnist_data, {"vq_nearest": 1, **generate}),
        ("eval_speed_control", eval_speed_control.main,
         ["--run", mnist_run, "--videos", "4", "--speeds", "0.05", "0.5", "0.95", "--gifs",
          "1", "--device", "cuda"] + mnist_data, {"vq_nearest": 2, **generate}),
        ("eval_speed_control_cater", eval_speed_control_cater.main,
         ["--run", os.path.join(tmp, "train_cater_e2e"), "--dataset", "caterv1",
          "--num-train", "16", "--num-val", "8", "--gifs", "1", "--device", "cuda"],
         {"vq_nearest": 1, "axial_slot_attention": 4 * 10, "cached_slot_attention": 2 * 10}),
    ]


def numbers(value) -> list:
    """Every int and float in a JSON-like value, lists and dicts flattened
    (bools and strings left out)."""
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        return [x for v in value for x in numbers(v)]
    return [float(value)] if isinstance(value, (int, float)) and not isinstance(value, bool) else []


def run_evals_phase(torch, kernels, card: str, tmp: str, probe) -> dict:
    """The evaluation path through its entry points, from the e2e chains'
    runs in ``tmp``: each step's launches must be ``evals_steps``' and every
    kernel launch at a new shape must hold against its plain version
    (``E2eProbe.hold``); the extractors train their 2 timed steps; the
    CATER trunk resolves as JAX's ``resolve_extractor`` would, and refuses
    the MNIST family; every number in the evals' records is finite but the
    rate correlation (nan where the generated rates are all equal, as
    ``np.corrcoef`` gives in JAX's evals too). A line per step (wall
    s, launches, held, what it measured) -> {label: line}."""
    import numpy as np

    from mage_tpu_torch.evals import fvd, i3d

    t_phase = time.perf_counter()
    lines = {}
    for label, fn, argv, want in evals_steps(tmp):
        probe.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out, launches, routes = count_launches(torch, kernels, lambda: fn(argv))
        wall = time.perf_counter() - t0
        expect(launches, want, label)
        held = probe.hold()
        if set(held) != {k for k, n in launches.items() if n}:
            raise AssertionError(f"{label}: held {sorted(held)}, launched {launches}")
        line = {"run": label, "card": card, "wall_s": wall,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "launches": {k: v for k, v in launches.items() if v}, "vq_variants": routes,
                "held": held}
        if label.startswith("train_fvd_extractor"):
            summary = probe.summary()
            if summary["extractor_steps"] != 2:
                raise AssertionError(f"{label}: {summary['extractor_steps']} steps, not 2")
            line.update(s_per_step=summary["extractor_s_per_step"], calibration=out)
        elif label == "eval_fvd_e2e":
            if not (out["extractor"].startswith(i3d.PROVENANCE) and out["feature_dim"] == 832):
                raise AssertionError(f"{label}: extractor {out['extractor']!r}")
            line["record"] = {k: v for k, v in out.items() if k != "time"}
        else:
            line["record"] = out
        bad = [k for k, v in (line.get("record") or {}).items()
               if k != "gen_gt_rate_correlation" and not all(map(math.isfinite, numbers(v)))]
        if bad:
            raise AssertionError(f"{label}: non-finite {bad}")
        log("evals run: " + json.dumps(line))
        lines[label] = line
        if label == "train_fvd_extractor caterv2":
            extract, prov, dim = fvd.resolve_extractor(
                "CATER-GEN-v1", 4, extractor_dir=os.path.join(tmp, "fvdx_cater"))
            feats = extract(np.random.RandomState(0).rand(2, 10, 128, 128, 3) * 2 - 1)
            if not (prov.startswith(i3d.PROVENANCE) and dim == 832
                    and feats.shape == (2, 832) and np.isfinite(feats).all()):
                raise AssertionError(f"resolve_extractor: {prov!r}, {dim}, {feats.shape}")
            try:
                fvd.resolve_extractor("MovingMNIST", 4,
                                      extractor_dir=os.path.join(tmp, "fvdx_cater"))
            except ValueError as e:
                log(f"resolve_extractor: CATER trunk {prov!r}, {dim}-d, finite features; "
                    f"MovingMNIST refused ({e})")
            else:
                raise AssertionError("resolve_extractor took a CATER trunk for MovingMNIST")
    log(f"evals phase took {time.perf_counter() - t_phase:.1f} s")
    return lines


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    os.chdir(root)
    try:
        import numpy as np
        import torch.nn.functional as F

        from mage_tpu_torch import _build
        from mage_tpu_torch.models import layers as tl
        from mage_tpu_torch.models.pipeline import build_pipeline
        from mage_tpu_torch.ops import axial_attention as ax
        from mage_tpu_torch.ops import cached_attention as ca
        from mage_tpu_torch.ops import gn_conv as gc
        from mage_tpu_torch.ops import vq
    except ImportError as e:
        print(f"chip_smoke: the mage_tpu_torch package is missing ({e})", file=sys.stderr)
        return 2

    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()[0]
        log(smi)
        kind = torch.cuda.get_device_name(0)
        log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        t_start = t0 = time.perf_counter()
        lib = _build.build(verbose=True)
        _build.library()
        log(f"built {os.path.relpath(lib, root)} in {time.perf_counter() - t0:.1f} s")

        gen = torch.Generator(device="cuda").manual_seed(0)
        rows = [check_vq(torch, vq, gen), check_axial(torch, F, ax, gen),
                check_cached(torch, F, ca, gen), check_gn_conv(torch, F, gc, gen),
                check_gn_stats(torch, gc, gen), check_axial_block(torch, ax, tl, gen)]
        kernels = {"vq_nearest": vq.KERNEL, "axial_slot_attention": ax.KERNEL,
                   "cached_slot_attention": ca.KERNEL, "gn_silu_conv3x3": gc.KERNEL,
                   "gn_stats": gc.KERNEL_STATS, "axial_block_fused": ax.KERNEL_BLOCK}
        mage, mage_path = run_main_path(torch, np, build_pipeline, kernels, smi, want={
            "vq_nearest": 1, "axial_slot_attention": 4 * FRAMES,
            "cached_slot_attention": 2 * FRAMES, "gn_silu_conv3x3": 0, "gn_stats": 0,
            "axial_block_fused": 0})
        run_reference_check(torch, np, build_pipeline)
        n_gn = sum(GN_CONV_SITES.values()) * (BATCH * (FRAMES - 1) // KL_CHUNK)
        magep, _ = run_main_path(torch, np, build_pipeline, kernels, smi,
                                 "config/mage+_caterv2.yaml", want={
                                     "vq_nearest": 0, "axial_slot_attention": 4 * FRAMES,
                                     "cached_slot_attention": 2 * FRAMES,
                                     "gn_silu_conv3x3": n_gn, "gn_stats": n_gn,
                                     "axial_block_fused": 0})
        run_magep_reference_check(torch, np, build_pipeline)
        fused, fused_path = run_main_path(torch, np, build_pipeline, kernels, smi, want={
            "vq_nearest": 1, "axial_slot_attention": 0,
            "cached_slot_attention": 2 * FRAMES, "gn_silu_conv3x3": 0, "gn_stats": 0,
            "axial_block_fused": 4 * FRAMES}, spatial_attn="fusedblock")
        log("MAGE fusedblock beside flat: " + json.dumps({
            key: {"flat": mage_path[key], "fusedblock": fused_path[key]}
            for key in ("generated_frames_per_s", "generate_s", "peak_mem_gib", "stage_ms")}))
        run_reference_check(torch, np, build_pipeline, spatial_attn="fusedblock")
        run_magep_reference_check(torch, np, build_pipeline, spatial_attn="fusedblock")
        run_magep_reference_check(torch, np, build_pipeline, spatial_attn="fusedblock",
                                  cached=False, length=4)
        paths = {"gn_silu_conv3x3": magep, "gn_stats": magep, "axial_block_fused": fused}
        for row in rows:  # each kernel's launches on the path that runs it
            row["launches"] = paths.get(row["name"], mage)[row["name"]]
            row.setdefault("conv_only_ms", None)
            row.setdefault("unfused_ms", None)

        # training, on torch's default precision flags (cuDNN may use TF32 for
        # the f32 frozen encode), as a trainer gets them; f32 checks without
        train_shapes = check_train_shapes(torch, vq, ax, tl, gen)
        torch.backends.cudnn.allow_tf32 = True
        t0 = time.perf_counter()
        per_train_step, per_eval_step, _ = run_training(torch, build_pipeline, kernels, smi)
        magep_batch = TRAIN_BATCH if time.perf_counter() - t_start < 300 else 4
        if magep_batch != TRAIN_BATCH:
            log(f"MAGE+ training at batch {magep_batch}: the smoke has run "
                f"{time.perf_counter() - t_start:.0f} s")
        run_magep_training(torch, build_pipeline, kernels, magep_batch)
        log(f"training phases took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        stage1_vq = check_stage1_vq(torch, vq, gen)
        for name in ("f8", "f4"):
            run_vqvae_training(torch, kernels, name, smi)
        run_klae_training(torch, kernels, smi)
        log(f"stage-1 training phases took {time.perf_counter() - t0:.1f} s")
        torch.backends.cudnn.allow_tf32 = False
        run_train_reference_check(torch, np, build_pipeline, kernels)
        t0 = time.perf_counter()
        run_stage1_reference_check(torch, kernels)
        log(f"stage-1 f32 GPU-vs-CPU check took {time.perf_counter() - t0:.1f} s")
        run_cli_phase(torch, np, kernels, smi)
        run_kvquant_phase(torch, np, build_pipeline, kernels, smi)
        e2e_lines, evals_lines = run_e2e_phase(torch, kernels, smi)
        for row in rows:  # over the five chains of the e2e phase, then the evals
            for key, phase in (("e2e", e2e_lines), ("evals", evals_lines)):
                row[f"{key}_launches"] = sum(line["launches"].get(row["name"], 0)
                                             for line in phase.values())
                errs = [line["held"][row["name"]]["max_abs_err"] for line in phase.values()
                        if row["name"] in line["held"]]
                row[f"{key}_max_abs_err"] = max(errs) if errs else None
        chains = sum(GN_CONV_SITES.values())
        for row in rows:  # per stage-1 train step and eval step (VQ-VAE; KL-AE for gn)
            row["stage1_launches"] = 1 if row["name"] == "vq_nearest" else 0
            row["stage1_eval_launches"] = {"vq_nearest": 1, "gn_silu_conv3x3": chains,
                                           "gn_stats": chains}.get(row["name"], 0)
            for name, numbers in stage1_vq.items():
                for key in ("ms", "plain_ms", "bound_ms"):
                    row[f"stage1_{name}_{key}"] = (numbers[key] if row["name"] == "vq_nearest"
                                                   else None)
        for row in rows:  # at the training path's shapes (vq: per train step)
            ms_bound = train_shapes.get(row["name"])
            row["train_ms"], row["train_bound_ms"] = ms_bound or (None, None)
            if row["name"] == "vq_nearest":
                row["train_launches"] = per_train_step["vq_nearest"]
            elif ms_bound is not None:
                row["train_launches"] = per_eval_step[
                    "fusedblock" if row["name"] == "axial_block_fused" else "flat"][row["name"]]
            else:
                row["train_launches"] = 0
    except Exception:
        traceback.print_exc()
        return 1

    stage1_keys = tuple(f"stage1_{name}_{key}" for name in S1_VQ_SHAPES
                        for key in ("ms", "plain_ms", "bound_ms"))
    for row in rows:
        for key in ("ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err",
                    "conv_only_ms", "unfused_ms", "train_ms", "train_bound_ms", *stage1_keys,
                    "e2e_max_abs_err", "evals_max_abs_err"):
            if row[key] is not None and not math.isfinite(row[key]):
                print(f"chip_smoke: {row['name']} {key} = {row[key]}", file=sys.stderr)
                return 1
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "conv_only_ms", "unfused_ms",
            "train_launches", "train_ms", "train_bound_ms", "stage1_launches",
            "stage1_eval_launches", *stage1_keys, "e2e_launches", "e2e_max_abs_err",
            "evals_launches", "evals_max_abs_err")
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
