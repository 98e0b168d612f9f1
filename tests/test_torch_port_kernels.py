"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Each test needs a CUDA device and skips without one (the decision is taken
inside the test). The shapes are ragged against the kernels' tiles, which
``chip_smoke.py`` (main-path shapes only) does not reach. On the card's
machine, which has no JAX, run them with
``python3 -m pytest --noconftest -q tests/test_torch_port_kernels.py``.
"""

import pytest
import torch

from mage_tpu_torch.ops import axial_attention as ax
from mage_tpu_torch.ops import cached_attention as ca
from mage_tpu_torch.ops import gn_conv as gc
from mage_tpu_torch.ops import vq
from mage_tpu_torch.ops import vq_tail as vt
from mage_tpu_torch.utils import trace

DTYPES = [torch.float32, torch.bfloat16]
# f32: the same math in another order; bf16: one rounding step of the output
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5), torch.bfloat16: dict(rtol=2**-7, atol=1e-5)}


def launched(kernel: str) -> int:
    """The launches of ``kernel``'s launcher counted so far in the process."""
    return trace.launch_counts().get(kernel, 0)


@pytest.fixture()
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,k,d", [(1000, 100, 72), (33, 512, 1024), (5, 7, 3),
                                   (8192, 512, 1024), (8193, 513, 1024), (129, 520, 1040)])
def test_vq_kernel_matches_plain(gen, dtype, n, k, d):
    """(8192, 512, 1024) is the main path's shape; 8193 rows and 513 codes
    are ragged against the bf16 variant's 64-row tiles and 512-code chunks
    and the SIMT variant's 128 x 128 tiles, D=1040 against both depths; D=3
    takes the SIMT variant in bf16 too. Codes 5 and k-1 are an exact tie in
    different chunk halves or CTAs."""
    z = torch.randn(n, d, generator=gen, device="cuda").to(dtype)
    cb = torch.randn(k, d, generator=gen, device="cuda").to(dtype)
    cb[k // 2] = cb[k // 3]  # an exact tie: the lower index must win
    z[0] = cb[k // 3]
    cb[k - 1] = cb[5]  # a tie across chunks or CTAs
    z[1] = cb[5]
    before = launched("vq")
    idx, codes = vq.nearest_with_codes(z, cb)
    assert launched("vq") == before + 1
    assert vq.route(z, cb) == ("wgmma" if dtype == torch.bfloat16 and d % 8 == 0 else "simt")
    ids_only = vq.nearest_codebook_indices(z, cb)
    assert launched("vq") == before + 2
    again, codes_again = vq.nearest_with_codes(z, cb)
    torch.testing.assert_close(ids_only, idx, rtol=0, atol=0)
    assert torch.equal(again, idx) and torch.equal(codes_again, codes)  # two launches bit-equal
    ref_idx, _ = vq.nearest_with_codes(z, cb, impl="torch")
    assert int(idx[0]) == k // 3 and int(ref_idx[0]) == k // 3
    assert int(idx[1]) == 5 and int(ref_idx[1]) == 5
    torch.testing.assert_close(codes, cb[idx.long()], rtol=0, atol=0)
    dist = (cb.double() ** 2).sum(1)[None] - 2 * z.double() @ cb.double().T
    rows = torch.arange(n, device="cuda")
    gap = (dist[rows, idx.long()] - dist[rows, ref_idx.long()]).abs()
    assert bool((gap <= 1e-5 * dist.abs().amax(1)).all())  # differ only at near-ties


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("g,s,d,heads", [(37, 7, 64, 2), (3, 16, 512, 16), (10, 1, 96, 3),
                                         (513, 16, 512, 16), (9, 32, 256, 8), (11, 16, 64, 8),
                                         (6, 16, 256, 4), (5, 5, 36, 3)])
def test_axial_kernel_matches_plain(gen, dtype, g, s, d, heads):
    """G=513 is not a multiple of the groups a block takes; S=32; hd 8, 64;
    hd=12 (not whole 16-byte vectors in bf16) takes the scalar edge."""
    q, k, v = (torch.randn(g, s, d, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    got = ax.axial_slot_attention(q, k, v, heads)
    want = ax.axial_slot_attention(q, k, v, heads, impl="torch")
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,length,d,heads", [(1001, 5, 64, 2), (7, 16, 512, 16),
                                              (130, 3, 256, 8)])
def test_cached_kernel_matches_plain(gen, dtype, n, length, d, heads):
    q = torch.randn(n, d, generator=gen, device="cuda").to(dtype)
    ck = torch.randn(length, n, d, generator=gen, device="cuda").to(dtype)
    cv = torch.randn(length, n, d, generator=gen, device="cuda").to(dtype)
    for pos in range(length):
        got = ca.cached_slot_attention(q, ck, cv, pos, heads)
        want = ca.cached_slot_attention(q, ck, cv, pos, heads, impl="torch")
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_kernels_reject_what_they_do_not_take(gen):
    q = torch.randn(4, 8, 64, generator=gen, device="cuda")
    with pytest.raises(ValueError):
        ax.axial_slot_attention(q, q, q, 3)  # 64 % 3 != 0
    with pytest.raises(TypeError):
        ax.axial_slot_attention(q.half(), q.half(), q.half(), 2)
    with pytest.raises(ValueError):
        ca.cached_slot_attention(q[0], q, q, 8, 2)  # pos past the cache
    with pytest.raises(TypeError):
        vq.nearest_codebook_indices(q[0], q[0].to(torch.bfloat16))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,w,c,cout", [(3, 1, 7, 16, 48), (1, 5, 130, 32, 16),
                                          (2, 16, 16, 512, 512), (2, 17, 17, 256, 128),
                                          (1, 17, 17, 512, 512), (3, 9, 13, 48, 32),
                                          (1, 33, 8, 128, 256)])
def test_gn_conv_kernel_matches_plain(gen, dtype, b, h, w, c, cout, monkeypatch):
    """16 GroupNorm groups (C=16 has no 32). Ragged against the bf16 tile
    (16 x 8 pixels, 128 or 256 channels, 64-channel chunks): H=W=17, two
    channel tiles at Cout=512, a 48-channel box that TMA fills past C with
    zeros, B=1. The op runs two kernels: the statistics are held to
    ``gn_affine_rows`` (1e-5 relative), and the output to the plain conv on
    the rows the statistics kernel gave it (rows that differ by ~1e-7 can
    round a bf16 activation the other way). bf16: one rounding step of the
    output, plus a 1e-3 floor (the kernel and the plain version sum in other
    orders)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    x = (torch.randn(b, h, w, c, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    gamma = torch.randn(c, generator=gen, device="cuda") * 0.5 + 1
    beta = torch.randn(c, generator=gen, device="cuda") * 0.2
    weight = torch.randn(cout, c, 3, 3, generator=gen, device="cuda") / (9 * c) ** 0.5
    bias = torch.randn(cout, generator=gen, device="cuda") * 0.1
    before = launched("gn_conv"), launched("gn_stats")
    got = gc.gn_silu_conv3x3(x, gamma, beta, weight, bias, groups=16)
    assert (launched("gn_conv"), launched("gn_stats")) == (before[0] + 1, before[1] + 1)
    a, shift = gc.gn_stats(x, gamma, beta, groups=16)
    for got_row, want_row in zip((a, shift), gc.gn_affine_rows(x, gamma, beta, 16, 1e-6)):
        torch.testing.assert_close(got_row, want_row, rtol=1e-5,
                                   atol=1e-5 * float(want_row.abs().max()))
    want = gc.silu_conv3x3_rows(x, a, shift, weight, bias)
    assert got.shape == (b, h, w, cout) and got.dtype == dtype
    tol = TOL[dtype] if dtype == torch.float32 else dict(rtol=2**-7, atol=1e-3)
    torch.testing.assert_close(got.float(), want.float(), **tol)


def test_gn_conv_rejects_what_it_does_not_take(gen):
    x = torch.randn(2, 4, 4, 32, generator=gen, device="cuda")
    ones, zeros = torch.ones(32, device="cuda"), torch.zeros(32, device="cuda")
    weight = torch.randn(32, 32, 3, 3, generator=gen, device="cuda")
    with pytest.raises(ValueError):  # C % 16 != 0
        gc.gn_silu_conv3x3(x[..., :24].contiguous(), ones[:24], zeros[:24],
                           weight[:, :24].contiguous(), zeros)
    with pytest.raises(ValueError):  # not contiguous
        gc.gn_silu_conv3x3(x.transpose(1, 2), ones, zeros, weight, zeros)
    with pytest.raises(ValueError):  # a parameter on the CPU
        gc.gn_silu_conv3x3(x, ones, zeros, weight.cpu(), zeros)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,w,c,groups", [(3, 1, 7, 16, 16), (2, 17, 17, 48, 16),
                                             (1, 5, 130, 512, 32), (2, 3, 5, 4096, 32),
                                             (96, 16, 16, 512, 32)])
def test_gn_stats_kernel_matches_plain(gen, dtype, b, h, w, c, groups):
    """Ragged against the kernel's 256-thread rows of 16-byte vectors (C=4096
    takes two and four channel slices), and the decoder's 16-px class. The
    sums run in another order than the plain version's: a and b within 1e-5
    relative. Two runs give the same rows bit for bit (no atomics)."""
    x = (torch.randn(b, h, w, c, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    gamma = torch.randn(c, generator=gen, device="cuda") * 0.5 + 1
    beta = torch.randn(c, generator=gen, device="cuda") * 0.2
    before = launched("gn_stats")
    a, shift = gc.gn_stats(x, gamma, beta, groups=groups)
    assert launched("gn_stats") == before + 1
    want_a, want_b = gc.gn_stats(x, gamma, beta, groups=groups, impl="torch")
    assert a.shape == shift.shape == (b, c) and a.dtype == shift.dtype == torch.float32
    torch.testing.assert_close(a, want_a, rtol=1e-5, atol=1e-5 * float(want_a.abs().max()))
    torch.testing.assert_close(shift, want_b, rtol=1e-5, atol=1e-5 * float(want_b.abs().max()))
    again = gc.gn_stats(x, gamma, beta, groups=groups)
    assert torch.equal(a, again[0]) and torch.equal(shift, again[1])


@pytest.mark.parametrize("dtype", DTYPES)
def test_gn_stats_kernel_clamps_a_cancelling_variance(gen, dtype):
    """|mean| >> std: around 300, E[x^2] - mean^2 cancels, and in f32 the
    difference is known only to a few ulps of E[x^2] (about 0.005 each),
    of either sign. Even groups are constant, so their variance is 0 and the
    clamp at 0 keeps a = gamma / sqrt(eps) finite (a negative variance past
    -eps would give NaN); odd groups spread by steps of 2 (bf16's step at
    300). The kernel and the plain version are both held to the exact f64
    statistics: the variance that a implies within 64 ulps of E[x^2], the
    mean that b implies within 1e-6 of it."""
    b, h, w, c, groups = 2, 17, 17, 64, 16
    gs = c // groups
    cpu = torch.Generator().manual_seed(1)
    step = torch.randint(-2, 3, (b, h, w, c), generator=cpu).float() * 2
    odd = ((torch.arange(c) // gs) % 2 == 1).float()
    x = (300.0 + step * odd).to(dtype).cuda()
    gamma = torch.rand(c, generator=gen, device="cuda") * 0.5 + 0.75  # a far from 0
    beta = torch.randn(c, generator=gen, device="cuda") * 0.2
    eps = 1e-6
    xd = x.double().reshape(b, h * w, groups, gs)
    mean = xd.mean(dim=(1, 3)).repeat_interleave(gs, dim=1)
    ex2 = (xd * xd).mean(dim=(1, 3)).repeat_interleave(gs, dim=1)
    var = (ex2 - mean * mean).clamp(min=0)
    for impl in ("auto", "torch"):
        a, shift = gc.gn_stats(x, gamma, beta, groups=groups, eps=eps, impl=impl)
        assert bool(torch.isfinite(a).all() and torch.isfinite(shift).all()), impl
        a64 = a.double()
        implied_var = (gamma.double()[None] / a64) ** 2 - eps
        assert bool(((implied_var - var).abs() <= 64 * 2.0 ** -24 * ex2).all()), impl
        implied_mean = (beta.double()[None] - shift.double()) / a64
        torch.testing.assert_close(implied_mean, mean, rtol=1e-6, atol=0)


def test_gn_stats_rejects_what_it_does_not_take(gen):
    x = torch.randn(2, 4, 4, 32, generator=gen, device="cuda")
    ones, zeros = torch.ones(32, device="cuda"), torch.zeros(32, device="cuda")
    with pytest.raises(ValueError):  # C % 16 != 0
        gc.gn_stats(x[..., :24].contiguous(), ones[:24], zeros[:24], groups=8)
    with pytest.raises(ValueError):  # groups do not divide C
        gc.gn_stats(x, ones, zeros, groups=5)
    with pytest.raises(ValueError):  # gamma on the CPU
        gc.gn_stats(x, ones.cpu(), zeros, groups=8)
    with pytest.raises(ValueError):  # not contiguous
        gc.gn_stats(x.transpose(1, 2), ones, zeros, groups=8)


def _block_params(gen, d, dtype):
    """The fused block's parameters at normal(0.02) scale, LayerNorms near unit."""
    def t(*shape, base=0.0, scale=0.02):
        return (base + torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

    return (t(d, base=1.0, scale=0.1), t(d), t(d, d), t(d), t(d, d), t(d), t(d, d), t(d),
            t(d, d), t(d), t(d, base=1.0, scale=0.1), t(d), t(4 * d, d), t(4 * d),
            t(d, 4 * d), t(d))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("g,s,d,heads", [(37, 7, 64, 2), (3, 16, 512, 16), (10, 1, 96, 3),
                                         (9, 7, 64, 2), (5, 13, 128, 4), (130, 16, 512, 16),
                                         (7, 32, 128, 2)])
def test_axial_block_kernel_matches_plain(gen, dtype, g, s, d, heads):
    """Ragged G against the kernel's tiles (64 rows of whole groups, clusters
    of two tiles in bf16): groups that do not fill a tile (S=7, 13), a ragged
    last cluster (G=130: 33 tiles), S=32 with hd=64; D=96 takes the mma.sync
    path. bf16: one rounding step of each value plus 2**-7 of the largest
    |output|, for an intermediate (seq, whose residual reaches the output)
    that rounds to its neighbouring bf16 value (the kernel and the plain
    version sum in other orders)."""
    x = torch.randn(g, s, d, generator=gen, device="cuda").to(dtype)
    params = _block_params(gen, d, dtype)
    before = launched("axial_block")
    got = ax.axial_block_fused(x, params, heads)
    assert launched("axial_block") == before + 1
    want = ax.axial_block_fused(x, params, heads, impl="torch")
    assert got.shape == (g, s, d) and got.dtype == dtype
    scale = float(want.float().abs().max())
    tol = TOL[dtype] if dtype == torch.float32 else dict(rtol=2**-7, atol=2**-7 * scale)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("g,s,d,heads", [(130, 16, 512, 16), (10, 1, 96, 3)])
def test_axial_block_kernel_is_deterministic(gen, g, s, d, heads):
    """Two launches on the same inputs give the same bits (no atomics, a
    fixed order of every sum)."""
    x = torch.randn(g, s, d, generator=gen, device="cuda").to(torch.bfloat16)
    params = _block_params(gen, d, torch.bfloat16)
    first = ax.axial_block_fused(x, params, heads)
    assert torch.equal(first, ax.axial_block_fused(x, params, heads))


def test_axial_block_rejects_what_it_does_not_take(gen):
    x = torch.randn(4, 8, 64, generator=gen, device="cuda")
    params = _block_params(gen, 64, torch.float32)
    with pytest.raises(ValueError):  # a CPU tensor
        ax._block_cuda(x.cpu(), tuple(p.cpu() for p in params), 2, 1e-5)
    with pytest.raises(TypeError):  # mixed dtypes
        ax.axial_block_fused(x.to(torch.bfloat16), params, 2)
    with pytest.raises(ValueError):  # not contiguous
        ax._block_cuda(x.transpose(0, 1), params, 2, 1e-5)
    with pytest.raises(ValueError):  # a weight that is not contiguous
        ax.axial_block_fused(x, params[:2] + (params[2].T,) + params[3:], 2)
    with pytest.raises(ValueError):  # 64 % 3 != 0
        ax.axial_block_fused(x, params, 3)
    with pytest.raises(ValueError):  # S past the limit
        ax.axial_block_fused(torch.randn(2, ax.BLOCK_MAX_S + 1, 64, generator=gen,
                                         device="cuda"), params, 2)


@pytest.mark.parametrize("op", ["axial_slot_attention", "axial_block_fused"])
def test_kernel_route_gradients_are_the_plain_versions(gen, op):
    """With inputs that need gradients the kernel still runs the forward
    (one launch) and the backward is the plain version's, so an eval-mode
    forward on the card trains every parameter, f32."""
    g, s, d, heads = 37, 16, 128, 4
    if op == "axial_slot_attention":
        inputs = [torch.randn(g, s, d, generator=gen, device="cuda") for _ in range(3)]
        kernel = "axial"

        def run(*t, impl="auto"):
            return ax.axial_slot_attention(*t, heads, impl=impl)
    else:
        inputs = [torch.randn(g, s, d, generator=gen, device="cuda"),
                  *_block_params(gen, d, torch.float32)]
        kernel = "axial_block"

        def run(x, *p, impl="auto"):
            return ax.axial_block_fused(x, p, heads, impl=impl)
    leaves = [t.requires_grad_() for t in inputs]
    up = torch.randn(g, s, d, generator=gen, device="cuda")
    before = launched(kernel)
    got_out = run(*leaves)
    assert launched(kernel) == before + 1
    got = torch.autograd.grad((got_out * up).sum(), leaves)
    assert launched(kernel) == before + 1  # the backward launches no kernel
    want = torch.autograd.grad((run(*leaves, impl="torch") * up).sum(), leaves)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))


@pytest.mark.parametrize("n,k,d", [(1000, 100, 72), (4096, 512, 256)])
def test_straight_through_gradients_on_the_card_equal_the_cpus(gen, n, k, d):
    """The VQ-VAE training forward's quantizer in f32 (the kernel's SIMT
    variant with codes; (4096, 512, 256) is the f4 step's shape): one launch
    forward and none backward; codes and ids equal the CPU's, the z gradient
    is the codes' gradient exactly, and the codebook gradient (the
    straight-through scatter plus an attached lookup's) equals the CPU's up to
    the order of its sums."""
    z = torch.randn(n, d, generator=gen, device="cuda")
    cb = torch.randn(k, d, generator=gen, device="cuda")
    up = torch.randn(n, d, generator=gen, device="cuda")
    out = {}
    for dev in ("cuda", "cpu"):
        zl, cbl = z.to(dev).requires_grad_(), cb.to(dev).requires_grad_()
        before = launched("vq")
        codes, idx = vq.vq_straight_through(zl, cbl)
        loss = (codes * up.to(dev)).sum() + (vq.codebook_lookup(cbl, idx) ** 2).sum()
        grads = torch.autograd.grad(loss, (zl, cbl))
        assert launched("vq") == before + (dev == "cuda")
        out[dev] = [t.detach().cpu() for t in (codes, idx, *grads)]
    (codes, idx, gz, gcb), (codes_c, idx_c, gz_c, gcb_c) = out["cuda"], out["cpu"]
    assert torch.equal(idx, idx_c) and torch.equal(codes, codes_c)
    assert torch.equal(gz, gz_c)
    torch.testing.assert_close(gcb, gcb_c, rtol=1e-5, atol=1e-5 * float(gcb_c.abs().max()))


# ---- the quantized KV cache: plain PyTorch on the card, no kernel ----------------


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_cache_attention_on_the_card_equals_the_cpus(gen, bits):
    """``quantize_kv_slot`` on the card gives the CPU's codes and scales bit
    for bit (true divisions), and ``cached_slot_attention_quant`` at every
    ``pos`` agrees with the CPU's within 1e-5 relative, f32, at the main
    path's N, L and D, without a launch of the cached-attention kernel."""
    n, length, d, heads = 8192, 16, 512, 16
    torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.randn(2 * length, n, d, generator=gen, device="cuda")
    codes, scales = zip(*(ca.quantize_kv_slot(s, heads, bits) for s in x))
    for s, c, sc in zip(x[:3], codes, scales):
        c_cpu, sc_cpu = ca.quantize_kv_slot(s.cpu(), heads, bits)
        assert torch.equal(c.cpu(), c_cpu) and torch.equal(sc.cpu(), sc_cpu)
    ck, cv = torch.stack(codes[:length]), torch.stack(codes[length:])
    sk, sv = torch.cat(scales[:length]), torch.cat(scales[length:])
    q = torch.randn(n, d, generator=gen, device="cuda")
    before = launched("cached")
    for pos in (0, 7, length - 1):
        got = ca.cached_slot_attention_quant(q, ck, cv, sk, sv, pos, heads).cpu()
        want = ca.cached_slot_attention_quant(q.cpu(), ck.cpu(), cv.cpu(), sk.cpu(), sv.cpu(),
                                              pos, heads)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    assert launched("cached") == before


def _small_pipeline(device, kv_quant):
    from mage_tpu_torch.models.pipeline import MagePipeline

    config = dict(
        first_stage_config={"target": "mage_tpu.models.vqvae.VectorQuantizedVAE",
                            "params": {"input_dim": 3, "down_ratio": 8, "dim": 8, "K": 32}},
        text_encoder_config={"params": {"vocab_size": 30, "context_length": 12,
                                        "transformer_width": 64, "transformer_layers": 1,
                                        "output_dim": 64}},
        ma_config={"params": {"layers": 1, "d_model": 64}},
        generate_decoder_config={"params": {"layers": 3, "model_channels": 64,
                                            "in_channels": 64, "out_channels": 32,
                                            "frames_length": 4}},
        codebook_size=32, frames_length=4, image_resolution=8, vision_width=64,
        use_cids=True)
    return MagePipeline(**config, device=device, seed=0, kv_quant=kv_quant)


@pytest.mark.parametrize("kv_quant", ["int8", "int4"])
def test_quantized_decode_slot_on_the_card_equals_the_cpus(gen, kv_quant):
    """One quantized ``decode_slot`` (the anchor at 0, a frame at 1) on the
    card against the CPU, f32, the same weights: trunk within 1e-4 of its
    largest value, codes equal but for a rounding flip in at most 1e-4 of
    them, scales within 1e-6 relative."""
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for dev in ("cuda", "cpu"):
        pipe = _small_pipeline(dev, kv_quant)
        dec = pipe.core.generate_model
        cache = dec.init_cache(2, 8, 8, torch.float32, dev)
        anchor = torch.randn(2, 8, 8, 64, generator=torch.Generator().manual_seed(1)).to(dev)
        slot = torch.randn(2, 8, 8, 64, generator=torch.Generator().manual_seed(2)).to(dev)
        with torch.no_grad():
            pipe.core.eval()
            dec.decode_slot(anchor, 0, cache, is_anchor=True)
            trunk = dec.decode_slot(slot, 1, cache)
        out[dev] = (trunk.cpu(), [t.cpu() for entry in cache.values() for t in entry])
    (trunk, cache), (trunk_c, cache_c) = out["cuda"], out["cpu"]
    torch.testing.assert_close(trunk, trunk_c, rtol=0, atol=1e-4 * float(trunk_c.abs().max()))
    for t, t_c in zip(cache, cache_c):
        if t.dtype == torch.int8:
            assert (t != t_c).float().mean() <= 1e-4 and (t - t_c).abs().max() <= 1
        else:
            torch.testing.assert_close(t, t_c, rtol=1e-6, atol=0)


def test_generate_cached_with_an_int8_cache_launches_no_cached_kernel(gen):
    pipe = _small_pipeline("cuda", "int8")
    lat0 = torch.randint(0, 32, (2, 1, 8, 8), generator=gen, device="cuda", dtype=torch.int32)
    text = torch.randint(3, 29, (2, 12), generator=gen, device="cuda")
    before, axial = launched("cached"), launched("axial")
    ids = pipe.core.generate_cached(lat0, text, torch.rand(2, generator=gen, device="cuda"))
    assert ids.shape == (2, 3, 8, 8)
    assert launched("cached") == before
    assert launched("axial") == axial + 2 * 4  # the spatial blocks still launch theirs
    pipe.core.generate_model.kv_quant = None
    pipe.core.generate_cached(lat0, text, torch.rand(2, generator=gen, device="cuda"))
    assert launched("cached") == before + 4  # one temporal block, 4 slots


def _tail_inputs(gen, b, h, w, c=64, cout=256, o=3):
    hh = torch.randn(b, h, w, c, generator=gen, device="cuda").to(torch.bfloat16)
    x = torch.randn(b, h // 2, w // 2, cout, generator=gen, device="cuda").to(torch.bfloat16)
    w7 = (torch.randn(cout, c, 3, 3, generator=gen, device="cuda") / (9 * c) ** 0.5)
    b7 = torch.randn(cout, generator=gen, device="cuda") * 0.1
    w8 = torch.randn(o, cout, 1, 1, generator=gen, device="cuda") / cout ** 0.5
    b8 = torch.randn(o, generator=gen, device="cuda") * 0.1
    return hh, x, *(t.to(torch.bfloat16) for t in (w7, b7, w8, b8))


@pytest.mark.parametrize("b,h,w", [(288, 128, 128), (3, 22, 14), (2, 18, 30), (1, 2, 2),
                                   (5, 34, 6), (1, 16, 8), (133, 16, 8)])
def test_vq_tail_kernel_matches_plain(gen, b, h, w, monkeypatch):
    """288 frames of 64 -> 128 px is the decode of a MAGE generate (batch 32,
    L=10); the others are ragged against the 16 x 8-pixel tile (22 x 14, 18 x
    30, 2 x 2, 34 x 6), one tile, and 133 tiles, one more than the card's
    blocks, so one block walks two. The kernel and the plain version do the
    same f32 math in other orders and round once: within one bf16 step of the
    output."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    args = _tail_inputs(gen, b, h, w)
    before = launched("vq_tail")
    got = vt.vq_decode_tail(*args)
    assert launched("vq_tail") == before + 1
    want = vt.vq_decode_tail(*args, impl="torch")
    assert got.shape == (b, h, w, 3) and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), **TOL[torch.bfloat16])
    assert torch.equal(vt.vq_decode_tail(*args), got)  # deterministic


def test_vq_tail_launches_once_per_decode_chunk(gen):
    """A bf16 f8 decode under no_grad launches the kernel once per frame
    chunk, counted in the enclosing span too; f32 and a decode with autograd
    recording take the layer chain. The fused decode is no further from the
    f32 decode than the bf16 layer chain is."""
    from mage_tpu_torch.models.pipeline import FirstStageVQVAE
    from mage_tpu_torch.models.vqvae import VectorQuantizedVAE

    torch.manual_seed(0)
    model = VectorQuantizedVAE(input_dim=3, down_ratio=8, dim=256, K=64).cuda().eval()
    ids = torch.randint(0, 64, (2, 6, 4, 4), generator=gen, device="cuda")
    first = FirstStageVQVAE(model)
    before = launched("vq_tail")
    exact = first.decode(ids, max_chunk=5)  # f32
    assert launched("vq_tail") == before
    model.to(torch.bfloat16)
    trace.clear()
    with trace.span("mage.decode"):
        fused = first.decode(ids, max_chunk=5)  # 12 frames: 3 chunks of 4
    assert launched("vq_tail") == before + 3
    assert trace.records()[-1]["launches"] == {"vq_tail": 3}
    with torch.enable_grad():
        chain = model.decode(ids.reshape(-1, 4, 4)).detach().reshape(fused.shape)
    assert launched("vq_tail") == before + 3
    err_fused = float((fused.float() - exact).abs().max())
    err_chain = float((chain.float() - exact).abs().max())
    assert err_fused <= err_chain + 2 ** -8


def test_vq_decode_at_the_cells_shape_is_the_materialised_chain(gen, monkeypatch):
    """288 frames of 16 x 16 ids in bf16, the decode of a MAGE generate at
    batch 32, L=10: bit-equal to the decoder whose upsamples
    ``F.interpolate`` computes (each upsampling block's id path and trunk
    upsampled, then the trunk's second relu), the tail kernel on both."""
    from mage_tpu_torch.models.pipeline import FirstStageVQVAE
    from mage_tpu_torch.models.vqvae import DecoderBlock, VectorQuantizedVAE
    from test_torch_port_vq_tail import _materialised, _materialised_trunk

    torch.manual_seed(0)
    model = VectorQuantizedVAE(input_dim=3, down_ratio=8, dim=256, K=512)
    first = FirstStageVQVAE(model.cuda().to(torch.bfloat16).eval())
    ids = torch.randint(0, 512, (32, 9, 16, 16), generator=gen, device="cuda")
    before = launched("vq_tail")
    with torch.no_grad():
        got = first.decode(ids)
        monkeypatch.setattr(DecoderBlock, "trunk", _materialised_trunk)
        monkeypatch.setattr(DecoderBlock, "forward", _materialised)
        want = first.decode(ids)
    assert launched("vq_tail") == before + 2
    assert got.shape == (32, 9, 128, 128, 3)
    assert torch.equal(got, want)


def test_vq_tail_rejects_what_it_does_not_take(gen):
    hh, x, w7, b7, w8, b8 = _tail_inputs(gen, 1, 8, 8)
    with pytest.raises(TypeError):  # f32
        vt.vq_decode_tail(hh.float(), x.float(), w7, b7, w8.float(), b8.float())
    with pytest.raises(ValueError):  # odd H
        vt.vq_decode_tail(hh[:, :7].contiguous(), x[:, :3].contiguous(), w7, b7, w8, b8)
    with pytest.raises(ValueError):  # widths other than the f8 decoder's at dim 256
        vt.vq_decode_tail(*_tail_inputs(gen, 1, 8, 8, 64, 512, 3))
    with pytest.raises(ValueError):
        vt.vq_decode_tail(*_tail_inputs(gen, 1, 8, 8, 64, 256, 1))
    with pytest.raises(ValueError):  # not contiguous
        vt.vq_decode_tail(hh.transpose(1, 2), x.transpose(1, 2), w7, b7, w8, b8)
