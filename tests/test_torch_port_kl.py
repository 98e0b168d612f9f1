"""The port's KL autoencoder and fused GroupNorm-SiLU-conv op against JAX.

``mage_tpu_torch.ops.gn_silu_conv3x3`` runs its plain version on the CPU
(the oracle its CUDA kernel is held to on the card) and is compared with
both the JAX XLA chain and the JAX Pallas kernel in interpret mode. The KL
autoencoder's weights are carried by ``compat.from_jax.export_autoencoder_kl``
and strict-loaded; its decoder runs against the JAX decoder with the fused
chain off and on (``MAGE_KL_FUSED``, set for the JAX side only) and for each
of JAX's exact upsample variants (``MAGE_KL_UP``), which the port's one
folded upsample must match. Everything is f32 and made from numpy seeds.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mage_tpu.models import autoencoder_kl as jkl  # noqa: E402
from mage_tpu.ops import gn_conv as jgc  # noqa: E402
from mage_tpu_torch.compat import from_jax  # noqa: E402
from mage_tpu_torch.models import autoencoder_kl as tkl  # noqa: E402
from mage_tpu_torch.models.pipeline import KL_FRAME_CHUNK, FirstStageKL  # noqa: E402
from mage_tpu_torch.ops import gn_conv as tgc  # noqa: E402

# the KL-AE of tests/test_autoencoder_kl.py's fused-decoder test: f2, 16 -> 8
DD = dict(ch=128, ch_mult=(1, 2), num_res_blocks=1, resolution=16)
B, RES, LAT = 2, 16, 8


def _gn_conv_inputs(b, h, w, c, cout, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, w, c).astype(np.float32) * 2 + 0.5,
            (rng.randn(c) * 0.5 + 1).astype(np.float32),
            (rng.randn(c) * 0.2).astype(np.float32),
            (rng.randn(3, 3, c, cout) / np.sqrt(9 * c)).astype(np.float32),
            (rng.randn(cout) * 0.1).astype(np.float32))


@pytest.mark.parametrize("jax_impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("b,h,w,c,cout", [(2, 8, 8, 128, 128), (1, 16, 16, 256, 128)])
def test_gn_silu_conv3x3_matches_jax(jax_impl, b, h, w, c, cout):
    x, gamma, beta, kernel, bias = _gn_conv_inputs(b, h, w, c, cout)
    args = [jnp.asarray(v) for v in (x, gamma, beta, kernel, bias)]
    if jax_impl == "xla":
        want = jgc.gn_silu_conv3x3_xla(*args)
    else:
        want = jgc.gn_silu_conv3x3(*args, interpret=True)
    got = tgc.gn_silu_conv3x3(torch.from_numpy(x), torch.from_numpy(gamma),
                              torch.from_numpy(beta),
                              torch.from_numpy(from_jax.conv2d_weight(kernel)),
                              torch.from_numpy(bias))
    assert got.shape == (b, h, w, cout) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_gn_affine_rows_match_jax():
    x, gamma, beta, _, _ = _gn_conv_inputs(3, 4, 5, 64, 16, seed=1)
    want = jgc.gn_affine_rows(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), 32, 1e-6)
    got = tgc.gn_affine_rows(torch.from_numpy(x), torch.from_numpy(gamma),
                             torch.from_numpy(beta), 32, 1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def _large_mean_inputs(seed=2):
    """Integers around 100, so every partial sum is exact in f32 and the
    cancelling E[x^2] - mean^2 (about 1e4 - 1e4) comes out the same in any
    summation order; the even groups are constant (variance 0, a = gamma /
    sqrt(eps)), the odd ones spread by up to 3."""
    rng = np.random.RandomState(seed)
    b, h, w, c, groups = 2, 4, 4, 64, 32
    odd = (np.arange(c) // (c // groups)) % 2 == 1
    x = 100.0 + rng.randint(-3, 4, size=(b, h, w, c)) * odd
    return (x.astype(np.float32), (rng.randn(c) * 0.5 + 1).astype(np.float32),
            (rng.randn(c) * 0.2).astype(np.float32))


@pytest.mark.parametrize("case", ["bf16", "large_mean"])
def test_gn_affine_rows_match_jax_on_bf16_and_large_mean(case):
    """``gn_affine_rows``, the statistics kernel's oracle, against JAX's. bf16:
    both read the same bf16 values and sum in f32. large_mean: |mean| >> std,
    with sums that are exact, so the two agree to the last rounding and the
    constant groups' variance is exactly 0."""
    if case == "bf16":
        x, gamma, beta, _, _ = _gn_conv_inputs(3, 5, 7, 64, 16, seed=2)
        xt, xj = torch.from_numpy(x).bfloat16(), jnp.asarray(x).astype(jnp.bfloat16)
        np.testing.assert_array_equal(xt.float().numpy(), np.asarray(xj, np.float32))
    else:
        x, gamma, beta = _large_mean_inputs()
        xt, xj = torch.from_numpy(x), jnp.asarray(x)
    want = jgc.gn_affine_rows(xj, jnp.asarray(gamma), jnp.asarray(beta), 32, 1e-6)
    got = tgc.gn_affine_rows(xt, torch.from_numpy(gamma), torch.from_numpy(beta), 32, 1e-6)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-7 * float(np.abs(np.asarray(w)).max()))
    if case == "large_mean":
        a = got[0].numpy()
        constant = (np.arange(64) // 2) % 2 == 0
        np.testing.assert_allclose(a[:, constant], np.broadcast_to(gamma[constant] * 1e3,
                                                                   a[:, constant].shape),
                                   rtol=1e-6)
        xd = x.astype(np.float64).reshape(2, 16, 32, 2)
        ex2, var = (xd ** 2).mean(axis=(1, 3)), xd.var(axis=(1, 3))
        assert (ex2[:, 1::2] > 1000 * var[:, 1::2]).all()  # E[x^2] - mean^2 cancels


def test_gn_stats_on_a_cpu_tensor_is_the_plain_version():
    x, gamma, beta, _, _ = _gn_conv_inputs(2, 3, 5, 64, 16, seed=3)
    args = (torch.from_numpy(x), torch.from_numpy(gamma), torch.from_numpy(beta))
    want = tgc.gn_affine_rows(*args, 16, 1e-5)
    for impl in ("auto", "torch"):
        got = tgc.gn_stats(*args, groups=16, eps=1e-5, impl=impl)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    with pytest.raises(ValueError):
        tgc.gn_stats(*args, impl="cuda")


def test_packed_weight_is_made_once_per_parameter():
    """The kernel's (Cout, 9 * C) weight and f32 bias are cached on the
    weight and made again when the weight or bias is written in place,
    replaced or cast."""
    conv = torch.nn.Conv2d(32, 48, 3, padding=1)
    w, b = conv.weight, conv.bias
    wk, b32 = tgc._packed(w, b, torch.float32)
    again = tgc._packed(w, b, torch.float32)
    assert again[0] is wk and again[1] is b32
    assert wk.shape == (48, 9 * 32) and wk.is_contiguous()
    with torch.no_grad():
        w.mul_(2)
    wk2, _ = tgc._packed(w, b, torch.float32)
    assert wk2 is not wk
    torch.testing.assert_close(wk2, 2 * wk, rtol=0, atol=0)
    bias_before = b.detach().clone()
    with torch.no_grad():
        b.add_(1)
    torch.testing.assert_close(tgc._packed(w, b, torch.float32)[1], bias_before + 1, rtol=0,
                               atol=0)
    half, _ = tgc._packed(w, b, torch.bfloat16)
    assert half.dtype == torch.bfloat16
    torch.testing.assert_close(half, wk2.bfloat16(), rtol=0, atol=0)
    conv.weight.data = conv.weight.data.clone()  # replaced: a new tensor under the parameter
    assert tgc._packed(w, b, torch.bfloat16)[0] is not half


def test_packed_weight_layout_rebuilds_the_conv():
    """The packed layout the kernel's tensor map reads, w[o][(dy * 3 + dx) *
    C + c], summed over the nine shifted windows of the zero-padded input in
    plain torch, is ``F.conv2d`` with the (Cout, C, 3, 3) weight."""
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(2, 5, 7, 16).astype(np.float32))
    weight = torch.from_numpy(rng.randn(32, 16, 3, 3).astype(np.float32))
    bias = torch.from_numpy(rng.randn(32).astype(np.float32))
    wk, b32 = tgc._packed(weight, bias, torch.float32)
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    got = b32.expand(2, 5, 7, 32).clone()
    for t in range(9):
        dy, dx = divmod(t, 3)
        got += xp[:, dy:dy + 5, dx:dx + 7, :] @ wk[:, t * 16:(t + 1) * 16].T
    want = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), weight, bias, padding=1)
    torch.testing.assert_close(got, want.permute(0, 2, 3, 1), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def kl_pair():
    """A JAX AutoencoderKL with its variables and the port's, strict-loaded."""
    jm = jkl.AutoencoderKL(embed_dim=4, z_channels=4, **DD)
    x = jnp.zeros((1, RES, RES, 3), jnp.float32)
    variables = jax.jit(jm.init)({"params": jax.random.PRNGKey(0)}, x, jax.random.PRNGKey(1))
    return jm, variables


def _port_kl(variables, **kw):
    tm = tkl.AutoencoderKL(embed_dim=4, z_channels=4, **{**DD, **kw}).eval()
    from_jax.load(tm, from_jax.export_autoencoder_kl(variables))
    return tm


@pytest.mark.parametrize("jax_fused", ["unset", "gnconv_interpret"])
@pytest.mark.parametrize("jax_up", ["dilated", "phased", "naive"])
def test_kl_decoder_matches_jax(kl_pair, jax_up, jax_fused, monkeypatch):
    jm, variables = kl_pair
    z = np.random.RandomState(2).randn(B, LAT, LAT, 4).astype(np.float32)
    monkeypatch.setenv("MAGE_KL_UP", jax_up)
    if jax_fused == "unset":
        monkeypatch.delenv("MAGE_KL_FUSED", raising=False)
    else:
        monkeypatch.setenv("MAGE_KL_FUSED", jax_fused)
    want = jax.jit(lambda v, z: jm.apply(v, z, method="decode"))(variables, jnp.asarray(z))

    calls = []
    real = tkl.gn_silu_conv3x3
    monkeypatch.setattr(tkl, "gn_silu_conv3x3",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    tm = _port_kl(variables)
    got = tm.decode(torch.from_numpy(z))
    assert got.shape == (B, RES, RES, 3)
    # 2 mid + 2 levels x 2 blocks = 6 decoder ResnetBlocks, 2 fused chains each
    assert len(calls) == 12
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    # train mode takes the unfused nn.GroupNorm -> silu -> nn.Conv2d chains
    calls.clear()
    unfused = tm.train().decode(torch.from_numpy(z))
    assert not calls
    np.testing.assert_allclose(unfused.detach().numpy(), got.detach().numpy(),
                               rtol=1e-4, atol=1e-4)


def test_kl_encoder_and_posterior_sample_match_jax(kl_pair):
    jm, variables = kl_pair
    rng = np.random.RandomState(3)
    videos = (rng.rand(B, 3, RES, RES, 3) * 2 - 1).astype(np.float32)
    noise = rng.randn(B, 3, LAT, LAT, 4).astype(np.float32)
    flat = jnp.asarray(videos.reshape(B * 3, RES, RES, 3))
    moments = jax.jit(lambda v, x: jm.apply(v, x, method="encode_moments"))(variables, flat)
    post = jkl.DiagonalGaussian(moments)
    want_z = post.mean + post.std * jnp.asarray(noise.reshape(B * 3, LAT, LAT, 4))

    fs = FirstStageKL(_port_kl(variables))
    got_m = fs.encode_moments(torch.from_numpy(videos))
    assert got_m.shape == (B, 3, LAT, LAT, 8)
    np.testing.assert_allclose(got_m.numpy().reshape(B * 3, LAT, LAT, 8), np.asarray(moments),
                               rtol=1e-5, atol=1e-5)
    got_z = fs.encode(torch.from_numpy(videos), noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got_z.numpy().reshape(B * 3, LAT, LAT, 4), np.asarray(want_z),
                               rtol=1e-5, atol=1e-5)
    gen_z = fs.encode(torch.from_numpy(videos), generator=torch.Generator().manual_seed(0))
    assert gen_z.shape == got_z.shape and not torch.equal(gen_z, got_z)


def test_diagonal_gaussian_matches_jax():
    rng = np.random.RandomState(4)
    moments = rng.randn(2, 3, 3, 8).astype(np.float32) * 3
    moments[0, 0, 0, 4] = 100.0  # clamped to logvar 20
    noise = rng.randn(2, 3, 3, 4).astype(np.float32)
    jg, tg = jkl.DiagonalGaussian(jnp.asarray(moments)), tkl.DiagonalGaussian(
        torch.from_numpy(moments))
    np.testing.assert_allclose(tg.kl().numpy(), np.asarray(jg.kl()), rtol=1e-6)
    np.testing.assert_array_equal(tg.mode().numpy(), np.asarray(jg.mode()))
    np.testing.assert_allclose(tg.sample(torch.from_numpy(noise)).numpy(),
                               np.asarray(jg.mean + jg.std * noise), rtol=1e-6)
    half = tkl.DiagonalGaussian(torch.from_numpy(moments).bfloat16())
    assert half.sample(generator=torch.Generator().manual_seed(1)).dtype == torch.bfloat16


def test_up_variants_equal_conv_of_nearest_upsample():
    """The folded 4x4 stride-2 transposed conv of ``_Up`` is
    conv3x3(nearest_up2(x)) with the same 3x3 weight and bias."""
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 7, 5, 16).astype(np.float32))
    up = tkl._Up(16)
    torch.nn.init.normal_(up.conv.bias)
    near = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2).permute(0, 3, 1, 2)
    want = up.conv(near).permute(0, 2, 3, 1)
    got = up(x)
    assert got.shape == want.shape == (2, 14, 10, 16)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_kl_carrier_strict_loads_with_level_attention():
    """With an attention resolution the carrier also maps the per-level
    ``down.{i}.attn.{j}``/``up.{i}.attn.{j}`` blocks; the decode agrees."""
    dd = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, resolution=16, attn_resolutions=(8,))
    jm = jkl.AutoencoderKL(embed_dim=4, z_channels=4, **dd)
    variables = jax.jit(jm.init)({"params": jax.random.PRNGKey(6)},
                                 jnp.zeros((1, RES, RES, 3)), jax.random.PRNGKey(7))
    sd = from_jax.export_autoencoder_kl(variables)
    assert {"encoder.down.1.attn.0.q.weight", "decoder.up.1.attn.1.proj_out.bias",
            "decoder.up.1.upsample.conv.weight", "encoder.down.0.downsample.conv.weight",
            "decoder.mid.attn_1.norm.weight"} <= set(sd)
    tm = tkl.AutoencoderKL(embed_dim=4, z_channels=4, **dd).eval()
    from_jax.load(tm, sd)
    assert set(tm.state_dict()) == set(sd)
    z = np.random.RandomState(8).randn(1, LAT, LAT, 4).astype(np.float32)
    want = jax.jit(lambda v, z: jm.apply(v, z, method="decode"))(variables, jnp.asarray(z))
    np.testing.assert_allclose(tm.decode(torch.from_numpy(z)).detach().numpy(),
                               np.asarray(want), rtol=1e-4, atol=1e-4)


def test_first_stage_kl_from_config_loads_an_ldm_checkpoint(kl_pair, tmp_path):
    """``ckpt_path`` loads an ldm-layout checkpoint (``state_dict`` with the
    training losses' ``loss.*`` keys, which are dropped) strictly."""
    _, variables = kl_pair
    sd = from_jax.to_torch(from_jax.export_autoencoder_kl(variables))
    torch.save({"state_dict": {**sd, "loss.logvar": torch.zeros(())}}, tmp_path / "kl.ckpt")
    params = {"monitor": "val/rec_loss", "embed_dim": 4, "lossconfig": {"target": "x"},
              "ckpt_path": str(tmp_path / "kl.ckpt"),
              "ddconfig": {"double_z": True, "z_channels": 4, "in_channels": 3, "out_ch": 3,
                           "attn_resolutions": [], "dropout": 0.0, **DD}}
    fs = FirstStageKL.from_config(params)
    assert fs.embed_dim == 4 and not fs.is_discrete and KL_FRAME_CHUNK == 96
    for key, value in sd.items():
        torch.testing.assert_close(fs.model.state_dict()[key], value, rtol=0, atol=0)
