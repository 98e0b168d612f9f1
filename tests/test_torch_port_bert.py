"""The BERT text head and config-chosen sub-component classes, in the port
against the JAX package, on the CPU, in f32.

The JAX head runs ``transformers``' ``FlaxBertModule``; the port's is its own
plain-PyTorch BERT. Random weights from a flax init at a small width are
carried into the port by ``compat.from_jax``. Tolerances: the head's output
and a pipeline's loss terms within 1e-5 relative.
"""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("transformers")
import jax.numpy as jnp  # noqa: E402

from mage_tpu_torch.compat import from_jax  # noqa: E402
from mage_tpu_torch.config import resolve_target  # noqa: E402
from mage_tpu_torch.models import layers as tl  # noqa: E402
from mage_tpu_torch.models.mage import FlatAxialDecoder  # noqa: E402
from mage_tpu_torch.models.pipeline import MagePipeline  # noqa: E402
from mage_tpu_torch.models.text_heads import BertTextualHead  # noqa: E402

RTOL = 1e-5
BERT = {"vocab_size": 30, "hidden_size": 32, "num_hidden_layers": 2,
        "num_attention_heads": 2, "intermediate_size": 64,
        "max_position_embeddings": 16, "pad_token_id": 0}
B, FRAMES, RES, LAT, K, W = 2, 4, 32, 8, 32, 64


@pytest.fixture(scope="module", autouse=True)
def keep_global_torch_rng():
    """Leave torch's global generator as this module found it: tests in
    other files draw from it unseeded, so their draws must not depend on
    whether this module ran first in their worker."""
    with torch.random.fork_rng():
        yield


def _text(seed=0, ctx=12):
    rng = np.random.RandomState(seed)
    text = np.zeros((B, ctx), np.int32)
    text[:, 0] = 1
    text[:, 1:5] = rng.randint(3, 29, size=(B, 4))
    text[0, 5] = 2
    text[1, 3:] = 0  # a shorter caption: more padding
    return text


def _jax_head(out_dim=16):
    from mage_tpu.models.text_heads import BertTextualHead as JaxHead

    head = JaxHead(out_dim=out_dim, bert_config=BERT)
    params = jax.jit(lambda: head.init(jax.random.PRNGKey(0), jnp.asarray(_text()),
                                       train=False))()["params"]
    return head, jax.tree_util.tree_map(np.asarray, params)


def test_bert_head_matches_jax_on_carried_weights():
    head, params = _jax_head()
    want = np.asarray(head.apply({"params": params}, jnp.asarray(_text()), train=False))
    port = BertTextualHead(out_dim=16, bert_config=BERT).eval()
    sd = from_jax.export_bert_text_head(params, prefix="")
    assert set(sd) == set(port.state_dict())
    from_jax.load(port, sd)
    with torch.no_grad():
        got = port(torch.from_numpy(_text())).numpy()
    assert got.shape == (B, 12, 16)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


def test_bert_head_loads_a_local_checkpoint_and_uses_berts_defaults(tmp_path):
    src = BertTextualHead(out_dim=8, bert_config={**BERT, "layer_norm_eps": 1e-7}).eval()
    (tmp_path / "config.json").write_text(json.dumps({**BERT, "layer_norm_eps": 1e-7}))
    # an HF checkpoint of BertForPreTraining names the encoder under bert. and
    # carries heads and buffers the encoder does not use
    sd = {f"bert.{k}": v for k, v in src.bert.state_dict().items()}
    sd["bert.embeddings.position_ids"] = torch.arange(16)[None]
    sd["cls.predictions.bias"] = torch.zeros(30)
    torch.save(sd, tmp_path / "pytorch_model.bin")
    loaded = BertTextualHead(out_dim=8, bert_path=str(tmp_path)).eval()
    assert loaded.bert.embeddings.LayerNorm.eps == 1e-7
    for k, v in src.bert.state_dict().items():
        torch.testing.assert_close(loaded.bert.state_dict()[k], v, rtol=0, atol=0)
    # the pipeline's init redraws the projection but keeps the pretrained BERT
    loaded.init_weights(torch.Generator().manual_seed(3))
    torch.testing.assert_close(loaded.bert.pooler.dense.weight, src.bert.pooler.dense.weight,
                               rtol=0, atol=0)
    base = BertTextualHead(out_dim=8)
    assert base.bert.embeddings.word_embeddings.weight.shape == (30522, 768)
    assert len(base.bert.encoder.layer) == 12
    assert base.bert.encoder.layer[0].intermediate.dense.weight.shape == (3072, 768)
    with pytest.raises(ValueError, match="gelu"):
        BertTextualHead(out_dim=8, bert_config={**BERT, "hidden_act": "relu"})


class UserTextEncoder(torch.nn.Module):
    """A user's own text encoder, named in a config by its dotted path."""

    def __init__(self, width: int, vocab_size: int = 30):
        super().__init__()
        self.embed = torch.nn.Embedding(vocab_size, width)

    def forward(self, text):
        return self.embed(text.long())


def test_resolve_target_maps_reference_and_jax_paths_and_imports_user_classes():
    assert resolve_target({"target": "modules.mage_model.BertTextualHead"}) is BertTextualHead
    assert resolve_target({"target": "mage_tpu.models.text_heads.BertTextualHead"}) is (
        BertTextualHead)
    assert resolve_target({"target": "mage_tpu.models.mage.FlatAxialDecoder"}) is (
        FlatAxialDecoder)
    assert resolve_target({"params": {}}, tl.MAEncoder) is tl.MAEncoder
    assert resolve_target(None, tl.MAEncoder) is tl.MAEncoder
    assert resolve_target({"target": f"{__name__}.UserTextEncoder"}) is UserTextEncoder
    # a user's class is built from its params and trains with the core
    cfg = _config({"target": f"{__name__}.UserTextEncoder",
                   "params": {"width": W}})
    pipe = MagePipeline(**cfg, device="cpu")
    assert type(pipe.core.text_encoder) is UserTextEncoder
    terms = pipe.loss_terms(_batch(), train=False)
    assert np.isfinite(terms["prediction"].item())


def _config(text_encoder_config):
    return dict(
        first_stage_config={"target": "modules.vqvae_model.VectorQuantizedVAE",
                            "params": {"input_dim": 3, "down_ratio": 4, "dim": 16, "K": K}},
        text_encoder_config=text_encoder_config,
        ma_config={"target": "modules.mage_model.MAEncoder",
                   "params": {"layers": 1, "d_model": W}},
        generate_decoder_config={"target": "modules.mage_model.FlatAxialDecoder",
                                 "params": {"layers": 3, "model_channels": W,
                                            "in_channels": W, "out_channels": K,
                                            "frames_length": FRAMES}},
        codebook_size=K, frames_length=FRAMES, image_resolution=LAT, vision_width=W,
        dropout=0.0, use_cids=True, randomness=False, alpha=0.001, beta=0.00025)


def _batch():
    rng = np.random.RandomState(5)
    return {"images": rng.rand(B, FRAMES, RES, RES, 3).astype(np.float32) - 0.5,
            "text": _text(1), "speed": np.array([0.2, 0.7], np.float32)}


def test_pipeline_selecting_the_bert_head_by_reference_target_matches_jax():
    from mage_tpu.models.pipeline import MagePipeline as JaxPipeline
    from mage_tpu.models.text_heads import BertTextualHead as JaxHead
    from mage_tpu.models.vqvae import VectorQuantizedVAE as JaxVQVAE

    te = {"target": "modules.mage_model.BertTextualHead",
          "params": {"out_dim": W, "bert_config": BERT}}
    cfg = _config(te)
    fs_vars = jax.jit(JaxVQVAE(**cfg["first_stage_config"]["params"]).init)(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, RES, RES, 3), jnp.float32))
    jp = JaxPipeline(**cfg, first_stage_variables=fs_vars)
    assert jp.core.text_encoder_cls is JaxHead
    batch = _batch()
    params = jp.init(jax.random.PRNGKey(0), batch)
    assert "bert" in params["text_encoder"]
    j_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    j_terms = jax.jit(lambda p: jp.loss_terms(p, j_batch, jax.random.PRNGKey(1),
                                              train=False))(params)

    tp = MagePipeline(**cfg, device="cpu")
    assert isinstance(tp.core.text_encoder, BertTextualHead)
    from_jax.load_pipeline(tp, params, jp.first_stage.variables, text_layers=0,
                           ma_layers=1, dec_layers=3)
    with torch.no_grad():
        terms = tp.loss_terms(batch, train=False)
    assert set(terms) == set(j_terms) == {"prediction", "speed_l2"}
    for key, value in terms.items():
        np.testing.assert_allclose(value.item(), float(j_terms[key]), rtol=RTOL,
                                   err_msg=key)
