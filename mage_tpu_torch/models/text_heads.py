"""The BERT text head, selectable from YAML.

Port of ``mage_tpu/models/text_heads.py``: a BERT encoder whose final
hidden states are projected to the motion-anchor width by a learned
``text_projection_key`` matrix (the reference's ``BertTextualHead``,
modules/mage_model.py:125-178). The encoder is written here in plain
PyTorch (word, position and token-type-0 embeddings, LayerNorm, post-LN
layers with exact-erf GELU, the pooler), so the port needs no
``transformers``. Its state-dict keys are HF's torch ``BertModel`` keys under
``bert.``, so a reference checkpoint with this head loads unchanged.

``bert_config`` is a dict of ``BertConfig`` field names (BERT's defaults
for the rest: bert-base-uncased's widths); ``bert_path`` is a local
directory holding ``config.json`` and ``pytorch_model.bin`` (no download).

Selected by ``text_encoder_config.target:
modules.mage_model.BertTextualHead`` (the reference alias) or
``mage_tpu.models.text_heads.BertTextualHead``.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

# transformers.BertConfig's defaults: bert-base-uncased
BERT_DEFAULTS = {
    "vocab_size": 30522,
    "hidden_size": 768,
    "num_hidden_layers": 12,
    "num_attention_heads": 12,
    "intermediate_size": 3072,
    "hidden_act": "gelu",
    "hidden_dropout_prob": 0.1,
    "attention_probs_dropout_prob": 0.1,
    "max_position_embeddings": 512,
    "type_vocab_size": 2,
    "initializer_range": 0.02,
    "layer_norm_eps": 1e-12,
    "pad_token_id": 0,
    "position_embedding_type": "absolute",
}
WEIGHTS_FILE = "pytorch_model.bin"


def resolve_bert_config(overrides: Optional[Mapping[str, Any]] = None) -> dict:
    """BERT's defaults updated by ``overrides`` (``BertConfig`` field names;
    fields this encoder does not read are kept and ignored)."""
    cfg = {**BERT_DEFAULTS, **dict(overrides or {})}
    if cfg["hidden_act"] != "gelu" or cfg["position_embedding_type"] != "absolute":
        raise ValueError("BertTextualHead supports hidden_act 'gelu' with absolute "
                         f"positions, not {cfg['hidden_act']!r} / "
                         f"{cfg['position_embedding_type']!r}")
    return cfg


class _Embeddings(nn.Module):
    def __init__(self, c: Mapping[str, Any]):
        super().__init__()
        h = c["hidden_size"]
        self.word_embeddings = nn.Embedding(c["vocab_size"], h)
        self.position_embeddings = nn.Embedding(c["max_position_embeddings"], h)
        self.token_type_embeddings = nn.Embedding(c["type_vocab_size"], h)
        self.LayerNorm = nn.LayerNorm(h, eps=c["layer_norm_eps"])
        self.dropout = nn.Dropout(c["hidden_dropout_prob"])

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        positions = torch.arange(ids.shape[-1], device=ids.device)[None]
        x = (self.word_embeddings(ids) + self.position_embeddings(positions)
             + self.token_type_embeddings.weight[0])
        return self.dropout(self.LayerNorm(x))


class _SelfAttention(nn.Module):
    def __init__(self, c: Mapping[str, Any]):
        super().__init__()
        h = c["hidden_size"]
        self.heads = c["num_attention_heads"]
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)
        self.dropout = nn.Dropout(c["attention_probs_dropout_prob"])

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        b, s, h = x.shape

        def split(t):
            return t.reshape(b, s, self.heads, h // self.heads).transpose(1, 2)

        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        q = q / math.sqrt(h // self.heads)  # flax scales the query first
        weights = self.dropout(torch.softmax(q @ k.transpose(-1, -2) + bias, dim=-1))
        return (weights @ v).transpose(1, 2).reshape(b, s, h)


class _DenseNorm(nn.Module):
    """Dense -> dropout -> LayerNorm(+ residual): BERT's ``*Output`` blocks."""

    def __init__(self, c: Mapping[str, Any], d_in: int):
        super().__init__()
        self.dense = nn.Linear(d_in, c["hidden_size"])
        self.LayerNorm = nn.LayerNorm(c["hidden_size"], eps=c["layer_norm_eps"])
        self.dropout = nn.Dropout(c["hidden_dropout_prob"])

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(self.dropout(self.dense(x)) + residual)


class _Attention(nn.Module):
    def __init__(self, c: Mapping[str, Any]):
        super().__init__()
        setattr(self, "self", _SelfAttention(c))
        self.output = _DenseNorm(c, c["hidden_size"])

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        return self.output(getattr(self, "self")(x, bias), x)


class _Intermediate(nn.Module):
    def __init__(self, c: Mapping[str, Any]):
        super().__init__()
        self.dense = nn.Linear(c["hidden_size"], c["intermediate_size"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.dense(x))  # exact erf GELU, BERT's "gelu"


class _Layer(nn.Module):
    def __init__(self, c: Mapping[str, Any]):
        super().__init__()
        self.attention = _Attention(c)
        self.intermediate = _Intermediate(c)
        self.output = _DenseNorm(c, c["intermediate_size"])

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        x = self.attention(x, bias)
        return self.output(self.intermediate(x), x)


class _Encoder(nn.Module):
    def __init__(self, c: Mapping[str, Any]):
        super().__init__()
        self.layer = nn.ModuleList(_Layer(c) for _ in range(c["num_hidden_layers"]))


class _Pooler(nn.Module):
    def __init__(self, c: Mapping[str, Any]):
        super().__init__()
        self.dense = nn.Linear(c["hidden_size"], c["hidden_size"])


class BertModel(nn.Module):
    """BERT's encoder in HF's torch module layout (``embeddings``,
    ``encoder.layer.{i}``, ``pooler``). ``forward(ids, attention_mask)`` ->
    the last hidden state; padded keys (mask 0) get the dtype's most
    negative value as attention bias, as flax BERT gives them. The pooler
    is built for key compatibility and not run (the head reads the last
    hidden state only)."""

    def __init__(self, config: Mapping[str, Any]):
        super().__init__()
        self.config = dict(config)
        self.embeddings = _Embeddings(config)
        self.encoder = _Encoder(config)
        self.pooler = _Pooler(config)

    def forward(self, ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        x = self.embeddings(ids)
        bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0,
                           torch.finfo(x.dtype).min).to(x.dtype)
        for layer in self.encoder.layer:
            x = layer(x, bias)
        return x


class BertTextualHead(nn.Module):
    """BERT encoder + the (hidden, ``out_dim``) projection
    ``text_projection_key``. ``forward(text)`` -> (B, S, out_dim), the
    contract of ``TransformerTextEncoder``; the padding id comes from the
    BERT config (``pad_token_id``). Dropout follows the module's mode."""

    def __init__(self, out_dim: int, bert_path: Optional[str] = None,
                 bert_config: Optional[Mapping[str, Any]] = None):
        super().__init__()
        if bert_path:
            with open(os.path.join(bert_path, "config.json")) as fp:
                bert_config = json.load(fp)
        self.bert_path = bert_path
        config = resolve_bert_config(bert_config)
        self.padding_idx = config["pad_token_id"]
        self.bert = BertModel(config)
        self.text_projection_key = nn.Parameter(torch.empty(config["hidden_size"], out_dim))
        self.init_weights(torch.Generator().manual_seed(0))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """BERT's init (normal(initializer_range) for every dense and
        embedding matrix, zero biases, unit LayerNorms) and hidden^-0.5
        normal for the projection, as the JAX head draws it; then, with
        ``bert_path``, its pretrained weights (``pytorch_model.bin``)."""
        std = self.bert.config["initializer_range"]
        for m in self.bert.modules():
            if isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, (nn.Linear, nn.Embedding)):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * std)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
        key = self.text_projection_key
        key.copy_(torch.randn(key.shape, generator=generator) * key.shape[0] ** -0.5)
        if self.bert_path:
            sd = torch.load(os.path.join(self.bert_path, WEIGHTS_FILE), map_location="cpu",
                            weights_only=True)
            # HF checkpoints name the modules under ``bert.`` (BertFor*) or
            # not (BertModel), and may carry the position-ids buffer
            sd = {k[len("bert."):] if k.startswith("bert.") else k: v for k, v in sd.items()}
            sd = {k: v for k, v in sd.items() if k in self.bert.state_dict()}
            self.bert.load_state_dict(sd, strict=True)

    def forward(self, text: torch.Tensor) -> torch.Tensor:
        text = text.long()
        hidden = self.bert(text, (text != self.padding_idx).long())
        return hidden @ self.text_projection_key
