"""The quantized KV cache (``kv_quant="int8"|"int4"``) against the JAX
package's ``MAGE_KV_QUANT``.

The slot quantizer's codes and scales must equal JAX's bit for bit (from f32
and from bf16 inputs); the quantized attention must agree within 1e-5
relative on the same codes and scales; and the cached sampler's ids must
equal JAX's at L=4 with both widths, the JAX side run with the environment
variable set (no JAX file changes). The weights are a JAX init carried by
``compat.from_jax``; inputs are drawn with numpy from a seed; f32 on the CPU.
"""

import numpy as np
import pytest
import torch

from mage_tpu_torch.models.mage import FlatAxialDecoder, MAGECore
from mage_tpu_torch.models.pipeline import MagePipeline
from mage_tpu_torch.ops.cached_attention import (
    cached_slot_attention,
    cached_slot_attention_quant,
    quantize_kv_slot,
)

N, D, H, L = 24, 128, 4, 6
B, FRAMES, RES, LAT, K = 2, 4, 64, 8, 32


def _slot(seed, dtype):
    """(N, D) values with per-head ranges that differ by orders of
    magnitude, rounded to ``dtype`` -> (numpy f32 of the rounded values,
    the same values as a torch tensor of ``dtype``)."""
    import jax.numpy as jnp

    rng = np.random.RandomState(seed)
    x = rng.randn(N, D).astype(np.float32) * np.repeat(
        np.float32([0.01, 1.0, 7.3, 250.0]), D // H)[None]
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    rounded = np.asarray(jnp.asarray(x, jdt).astype(jnp.float32))
    return rounded, torch.from_numpy(rounded).to(dtype)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_kv_slot_matches_jax_bit_for_bit(bits, dtype):
    import jax.numpy as jnp

    from mage_tpu.ops.cached_attention import quantize_kv_slot as jax_quantize

    x, t = _slot(bits + (dtype == torch.bfloat16), dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    j_codes, j_scale = jax_quantize(jnp.asarray(x, jdt), H, bits)
    codes, scale = quantize_kv_slot(t, H, bits)
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    assert codes.shape == (N, D) and scale.shape == (1, H)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(j_codes.astype(jnp.int8)))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(j_scale))
    assert int(codes.abs().max()) == 2 ** (bits - 1) - 1


@pytest.mark.parametrize("pos", [0, 2, L - 1])
def test_cached_slot_attention_quant_matches_jax(pos):
    import jax.numpy as jnp

    from mage_tpu.ops.cached_attention import (
        cached_slot_attention_quant as jax_attn,
        quantize_kv_slot as jax_quantize,
    )

    rng = np.random.RandomState(10 + pos)
    q = rng.randn(N, D).astype(np.float32)
    slots = [jax_quantize(jnp.asarray(rng.randn(N, D).astype(np.float32)), H, 8)
             for _ in range(2 * L)]
    ck = np.stack([np.asarray(c) for c, _ in slots[:L]])
    cv = np.stack([np.asarray(c) for c, _ in slots[L:]])
    sk = np.concatenate([np.asarray(s) for _, s in slots[:L]])
    sv = np.concatenate([np.asarray(s) for _, s in slots[L:]])
    want = np.asarray(jax_attn(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                               jnp.asarray(sk), jnp.asarray(sv), jnp.int32(pos), H))
    got = cached_slot_attention_quant(torch.from_numpy(q), torch.from_numpy(ck),
                                      torch.from_numpy(cv), torch.from_numpy(sk),
                                      torch.from_numpy(sv), pos, H).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    # the dequantized cache through the unquantized op: the same attention
    deq_k = torch.from_numpy(ck.astype(np.float32) * np.repeat(sk, D // H, axis=1)[:, None])
    deq_v = torch.from_numpy(cv.astype(np.float32) * np.repeat(sv, D // H, axis=1)[:, None])
    plain = cached_slot_attention(torch.from_numpy(q), deq_k, deq_v, pos, H).numpy()
    np.testing.assert_allclose(got, plain, rtol=1e-4, atol=1e-4 * np.abs(plain).max())


def _config():
    return dict(
        first_stage_config={"target": "mage_tpu.models.vqvae.VectorQuantizedVAE",
                            "params": {"input_dim": 3, "down_ratio": 8, "dim": 8, "K": K}},
        text_encoder_config={"target": "mage_tpu.models.layers.TransformerTextEncoder",
                             "params": {"vocab_size": 30, "context_length": 12,
                                        "transformer_width": 64, "transformer_layers": 1,
                                        "output_dim": 64, "padding_idx": 0,
                                        "dropout": 0.1}},
        ma_config={"target": "mage_tpu.models.layers.MAEncoder",
                   "params": {"layers": 1, "d_model": 64}},
        generate_decoder_config={"target": "mage_tpu.models.mage.FlatAxialDecoder",
                                 "params": {"layers": 3, "model_channels": 64,
                                            "in_channels": 64, "out_channels": K,
                                            "frames_length": FRAMES}},
        codebook_size=K, frames_length=FRAMES, image_resolution=LAT, vision_width=64,
        dropout=0.1, use_cids=True, randomness=False,
    )


def _batch():
    rng = np.random.RandomState(0)
    text = np.zeros((B, 12), np.int32)
    text[:, 0] = 1
    text[:, 1:5] = rng.randint(3, 29, size=(B, 4))
    return {"images": rng.rand(B, FRAMES, RES, RES, 3).astype(np.float32) * 2 - 1,
            "text": text, "speed": rng.rand(B).astype(np.float32)}


@pytest.fixture(scope="module")
def jax_pipeline():
    jax = pytest.importorskip("jax")
    from mage_tpu.models.pipeline import MagePipeline as JaxPipeline

    from mage_tpu.models.vqvae import VectorQuantizedVAE

    # the first stage initialised under jit: the pipeline's own eager init
    # takes tens of seconds on the CPU
    vq = VectorQuantizedVAE(**_config()["first_stage_config"]["params"])
    fs = jax.jit(lambda: vq.init(jax.random.PRNGKey(0), jax.numpy.zeros((1, RES, RES, 3)),
                                 train=True))()
    jp = JaxPipeline(**_config(), first_stage_variables=fs)
    return jp, jax.jit(jp.init)(jax.random.PRNGKey(0), _batch())


@pytest.mark.parametrize("kv_quant", ["int8", "int4"])
def test_generate_cached_ids_match_jax_with_a_quantized_cache(kv_quant, jax_pipeline,
                                                               monkeypatch):
    import jax
    import jax.numpy as jnp

    from mage_tpu_torch.compat import from_jax

    monkeypatch.setenv("MAGE_KV_QUANT", kv_quant)
    jp, params = jax_pipeline
    batch = _batch()
    lat0 = jax.jit(jp.encode_first_stage)(jnp.asarray(batch["images"][:, 0:1]))
    j_ids = jax.jit(lambda p, *a: jp.core.apply({"params": p}, *a, method="generate_cached"))(
        params, lat0, jnp.asarray(batch["text"]), jnp.asarray(batch["speed"]))

    tp = MagePipeline(**_config(), device="cpu", kv_quant=kv_quant)
    from_jax.load_pipeline(tp, params, jp.first_stage.variables, text_layers=1,
                           ma_layers=1, dec_layers=3)
    cache = tp.core.generate_model.init_cache(B, LAT, LAT, torch.float32, "cpu")
    assert all(len(e) == 4 and e[0].dtype == torch.int8 and e[2].shape == (FRAMES, 2)
               for e in cache.values())
    t_ids = tp.core.generate_cached(torch.from_numpy(np.asarray(lat0)),
                                    torch.from_numpy(batch["text"]),
                                    torch.from_numpy(batch["speed"]))
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))


def test_kv_quant_rejects_unknown_values_and_other_head_widths():
    with pytest.raises(ValueError, match="kv_quant must be"):
        FlatAxialDecoder(8, 64, 8, 4, 3, kv_quant="int2")
    with pytest.raises(ValueError, match="kv_quant must be"):
        MAGECore(8, 4, 4, 32, ma_d_model=64, dec_layers=3, kv_quant="fp8")
    # 48 channels: one head of width 48, whose scale column JAX would not fit
    with pytest.raises(ValueError, match="heads of width 32"):
        FlatAxialDecoder(8, 48, 8, 4, 3, kv_quant="int8")
    decoder = FlatAxialDecoder(8, 48, 8, 4, 3)  # unquantized: any width
    decoder.kv_quant = "int4"
    with pytest.raises(ValueError, match="heads of width 32"):
        decoder.init_cache(1, 2, 2, torch.float32, "cpu")


def test_decode_slot_takes_kv_quant_alone_and_rejects_another_cache():
    """``kv_quant`` decides the attention; a cache made under the other
    setting raises instead of being read as the wrong kind."""
    decoder = FlatAxialDecoder(8, 64, 8, 4, 3, kv_quant="int8").eval()
    slot = torch.randn(1, 2, 2, 8, generator=torch.Generator().manual_seed(0))
    quant = decoder.init_cache(1, 2, 2, torch.float32, "cpu")
    decoder.kv_quant = None
    plain = decoder.init_cache(1, 2, 2, torch.float32, "cpu")
    with torch.no_grad():
        with pytest.raises(ValueError, match="make it with init_cache"):
            decoder.decode_slot(slot, 0, quant, is_anchor=False)
        decoder.decode_slot(slot, 0, plain)
        decoder.kv_quant = "int4"
        with pytest.raises(ValueError, match="make it with init_cache"):
            decoder.decode_slot(slot, 0, plain)
        decoder.decode_slot(slot, 0, quant)
    assert quant["layer_0"][0][0].abs().max() <= 7  # written at int4's width
