"""Stage-2 building blocks: attention, axial blocks, text encoder, 3D-conv
posterior blocks, AdaIN.

Port of ``mage_tpu/models/layers.py``. Parameter names are the reference
state-dict keys: attention keeps torch's packed ``in_proj_weight``/
``in_proj_bias`` and ``out_proj``, the text encoder its
``transformer.layers.{i}`` stack, the cross-attention block its
``ln_q``/``ln_kv`` (applied in MAGE+ only).

torch's ``train()``/``eval()`` mode stands for JAX's ``train`` argument:
dropout acts in train mode only. Each module's dropout rate defaults to 0;
``MAGECore`` passes the config's rate.

Eval-mode blocks that attend along H or W go through
``ops.axial_slot_attention`` between plain projections (``spatial_attn=
"flat"``, the default) or run whole through ``ops.axial_block_fused``
(``"fusedblock"``, JAX's ``MAGE_SPATIAL_ATTN=fusedblock``); in train mode
they run the plain layers, as JAX gates its kernels on ``not train``. The
temporal blocks of the cached sampler go through
``ops.cached_slot_attention`` and write the new slot's K/V into the cache in
place; over a quantized cache (``kv_quant``) they quantize the slot's K/V
per head on write and attend through ``ops.cached_slot_attention_quant``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mage_tpu_torch.ops.axial_attention import axial_block_fused, axial_slot_attention
from mage_tpu_torch.ops.cached_attention import (
    cached_slot_attention,
    cached_slot_attention_quant,
    quantize_kv_slot,
)
from mage_tpu_torch.ops.quick_gelu import quick_gelu
from mage_tpu_torch.parallel import tensor_parallel as tp

NEG_INF = -1e9  # additive mask value, as in the JAX package
SPATIAL_ATTN = ("flat", "fusedblock")  # routes of an unmasked (H or W) block


def lecun_normal_(p: torch.Tensor, generator: torch.Generator) -> None:
    """In place: flax's default kernel init, ``variance_scaling(1, "fan_in",
    "truncated_normal")`` (fan_in: every dimension of a torch weight but the
    first): a normal cut at two of its standard deviations and widened by
    1 / 0.8796 so that the cut values have variance 1/fan_in. Drawn by the
    inverse CDF from one uniform per value, on the CPU, so that a seed gives
    the same weights on every device and torch release
    (``torch.nn.init.trunc_normal_`` rejection-samples in recent releases,
    which takes a data-dependent number of draws and shifts every later one)."""
    s = p[0].numel() ** -0.5 / 0.87962566103423978
    b = math.erf(math.sqrt(2.0))  # erfinv maps U(-b, b) to normals cut at 2 sigma / sqrt 2
    u = torch.empty(p.shape).uniform_(-b, b, generator=generator)
    p.copy_(u.erfinv_().mul_(s * math.sqrt(2.0)).clamp_(-2 * s, 2 * s))


class MultiHeadAttention(nn.Module):
    """Multi-head attention with an additive bias and a key-padding mask
    (True = masked), keyed like ``torch.nn.MultiheadAttention``. Inputs are
    (..., L, D); heads split as (..., L, heads, hd). ``attn_dropout`` drops
    attention weights in train mode. Under a tensor-parallel split
    (``parallel.tensor_parallel``) the weights hold this rank's heads, and
    the layer runs on those heads only."""

    def __init__(self, d_model: int, n_head: int, attn_dropout: float = 0.0):
        super().__init__()
        self.d_model = d_model
        self.n_head = n_head
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        self.weight_dropout = nn.Dropout(attn_dropout)

    def _proj(self, x: torch.Tensor, i: int) -> torch.Tensor:
        d = self.in_proj_weight.shape[0] // 3  # d_model / tp under a split
        bias = self.in_proj_bias[i * self.d_model:(i + 1) * self.d_model]
        if d != self.d_model:
            return tp.column_linear(x, self.in_proj_weight[i * d:(i + 1) * d], bias)
        return F.linear(x, self.in_proj_weight[i * d:(i + 1) * d], bias)

    def project_q(self, x):
        return self._proj(x, 0)

    def project_kv(self, x):
        return self._proj(x, 1), self._proj(x, 2)

    def attend(self, q, k, v, bias: Optional[torch.Tensor] = None,
               key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Projected (..., Lq, D) q and (..., Lk, D) k, v -> (..., Lq, D)."""
        hd = self.d_model // self.n_head
        h = q.shape[-1] // hd  # this rank's heads under a split
        qh = q.unflatten(-1, (h, hd))
        kh = k.unflatten(-1, (h, hd))
        vh = v.unflatten(-1, (h, hd))
        scores = torch.einsum("...qhd,...khd->...hqk", qh, kh) / math.sqrt(hd)
        if bias is not None:
            scores = scores + bias.to(scores.dtype)  # an f32 bias must not promote bf16
        if key_padding_mask is not None:
            scores = scores + torch.where(
                key_padding_mask[:, None, None, :], NEG_INF, 0.0).to(scores.dtype)
        w = self.weight_dropout(torch.softmax(scores, dim=-1))
        out = torch.einsum("...hqk,...khd->...qhd", w, vh).flatten(-2)
        if out.shape[-1] != self.d_model:
            return tp.row_linear(out, self.out_proj.weight, self.out_proj.bias)
        return self.out_proj(out)

    def forward(self, q, k, v, bias=None, key_padding_mask=None):
        return self.attend(self.project_q(q), self._proj(k, 1), self._proj(v, 2),
                           bias=bias, key_padding_mask=key_padding_mask)


class MLP(nn.Module):
    """d -> 4d -> d with QuickGELU (``ops.quick_gelu``: one kernel pass
    forward and one backward on the card)."""

    def __init__(self, d_model: int):
        super().__init__()
        self.c_fc = nn.Linear(d_model, 4 * d_model)
        self.c_proj = nn.Linear(4 * d_model, d_model)

    def forward(self, x):
        if self.c_fc.weight.shape[0] != self.c_fc.out_features:  # a tensor-parallel split
            h = quick_gelu(tp.column_linear(x, self.c_fc.weight, self.c_fc.bias))
            return tp.row_linear(h, self.c_proj.weight, self.c_proj.bias)
        return self.c_proj(quick_gelu(self.c_fc(x)))


class AxialAttentionBlock(nn.Module):
    """Pre-LN self-attention + MLP along one axis of (B, T, H, W, C)
    (``axial_dim``: 1 = T, 2 = H, 3 = W), with ``dropout`` on both residual
    branches in train mode. ``spatial_attn`` picks the eval-mode route of a
    call without ``attn_bias``: ``"flat"`` runs the block's layers with the
    flat attention op between them, ``"fusedblock"`` the whole block as one
    op on the block's own parameters. In train mode every call runs the
    plain layers."""

    def __init__(self, d_model: int, n_head: int, axial_dim: int = 1,
                 spatial_attn: str = "flat", dropout: float = 0.0):
        super().__init__()
        if spatial_attn not in SPATIAL_ATTN:
            raise ValueError(f"spatial_attn must be one of {SPATIAL_ATTN}, got {spatial_attn!r}")
        self.n_head = n_head
        self.axial_dim = axial_dim
        self.spatial_attn = spatial_attn
        self.attn = MultiHeadAttention(d_model, n_head)
        self.ln_1 = nn.LayerNorm(d_model, eps=1e-5)
        self.ln_2 = nn.LayerNorm(d_model, eps=1e-5)
        self.mlp = MLP(d_model)
        self.resid_dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, attn_bias: Optional[torch.Tensor] = None):
        axis = self.axial_dim if self.axial_dim > 0 else self.axial_dim + x.ndim
        moved = torch.movedim(x, axis, -2)  # (..., S, C)
        shape = moved.shape
        seq = moved.reshape(-1, shape[-2], shape[-1])
        # the ops' kernels serve eval mode only, as in JAX (dropout is off there)
        spatial_op = attn_bias is None and not self.training
        if spatial_op and self.spatial_attn == "fusedblock":
            out = axial_block_fused(seq, self.fused_block_params(), self.n_head,
                                    eps=self.ln_1.eps)
            return torch.movedim(out.reshape(shape), -2, axis)
        h = self.ln_1(seq)
        if spatial_op:
            # unmasked axis: the flat (G, S, D) attention op (kernel on CUDA)
            g, s = h.shape[0], h.shape[1]
            q = self.attn.project_q(h)
            k, v = self.attn.project_kv(h)
            attn_out = self.attn.out_proj(
                axial_slot_attention(q, k, v, self.n_head).reshape(g, s, -1))
        else:
            attn_out = self.attn(h, h, h, bias=attn_bias)
        seq = seq + self.resid_dropout(attn_out)
        seq = seq + self.resid_dropout(self.mlp(self.ln_2(seq)))
        return torch.movedim(seq.reshape(shape), -2, axis)

    def fused_block_params(self) -> tuple:
        """The parameters ``ops.axial_block_fused`` takes, as views of this
        block's own: LN1, the q, k and v rows of the packed in-projection
        with their biases, out-proj, LN2, c_fc and c_proj."""
        d = self.attn.d_model
        w, b = self.attn.in_proj_weight, self.attn.in_proj_bias
        return (self.ln_1.weight, self.ln_1.bias,
                w[:d], b[:d], w[d:2 * d], b[d:2 * d], w[2 * d:], b[2 * d:],
                self.attn.out_proj.weight, self.attn.out_proj.bias,
                self.ln_2.weight, self.ln_2.bias,
                self.mlp.c_fc.weight, self.mlp.c_fc.bias,
                self.mlp.c_proj.weight, self.mlp.c_proj.bias)

    def _temporal_slot(self, x_slot: torch.Tensor, attend) -> torch.Tensor:
        """The block on one temporal slot (B, H, W, C), with ``attend(q, k,
        v)`` -> (B*H*W, C) storing the slot's K/V and attending over the
        cache."""
        b, hgt, wdt, c = x_slot.shape
        seq = x_slot.reshape(b * hgt * wdt, c)
        h = self.ln_1(seq)
        q = self.attn.project_q(h)
        k, v = self.attn.project_kv(h)
        seq = seq + self.attn.out_proj(attend(q, k, v))
        seq = seq + self.mlp(self.ln_2(seq))
        return seq.reshape(b, hgt, wdt, c)

    def incremental_temporal(self, x_slot: torch.Tensor, cache_k: torch.Tensor,
                             cache_v: torch.Tensor, pos: int) -> torch.Tensor:
        """One new temporal slot (B, H, W, C) of a causal T-block: writes its
        K/V into slot ``pos`` of the time-major (L, B*H*W, C) caches and
        attends over slots <= pos. The caches are updated in place, which
        saves the copy of the whole cache that a functional update makes."""

        def attend(q, k, v):
            cache_k[pos].copy_(k)
            cache_v[pos].copy_(v)
            return cached_slot_attention(q, cache_k, cache_v, pos, self.n_head)

        return self._temporal_slot(x_slot, attend)

    def incremental_temporal_quant(self, x_slot: torch.Tensor, cache_k: torch.Tensor,
                                   cache_v: torch.Tensor, scale_k: torch.Tensor,
                                   scale_v: torch.Tensor, pos: int,
                                   bits: int = 8) -> torch.Tensor:
        """``incremental_temporal`` over a quantized cache: (L, B*H*W, C)
        int8 codes and (L, n_head) f32 scales. The slot's K/V are quantized
        per head to ``bits`` (8 or 4) and written with their scales into
        slot ``pos`` in place; the attention folds the scales into its
        scores and weights."""

        def attend(q, k, v):
            for cache, scale, x in ((cache_k, scale_k, k), (cache_v, scale_v, v)):
                codes, s = quantize_kv_slot(x, self.n_head, bits)
                cache[pos].copy_(codes)
                scale[pos].copy_(s[0])
            return cached_slot_attention_quant(q, cache_k, cache_v, scale_k, scale_v, pos,
                                               self.n_head)

        return self._temporal_slot(x_slot, attend)

    def single_slot_spatial(self, x_slot: torch.Tensor) -> torch.Tensor:
        """Run this H- or W-axis block on one temporal slot (B, H, W, C)."""
        return self(x_slot[:, None])[:, 0]


class CrossAttentionBlock(nn.Module):
    """q x (k, v) cross-attention + MLP, ``dropout`` on both residual
    branches in train mode. ``pre_ln=False`` is MAGE (no LN on q/kv;
    ``ln_q``/``ln_kv`` exist only so reference checkpoints load strictly),
    ``pre_ln=True`` is MAGE+: ``q + attn(ln_q(q), ln_kv(k), ln_kv(v))``."""

    def __init__(self, d_model: int, n_head: int, dropout: float = 0.0,
                 pre_ln: bool = False):
        super().__init__()
        self.pre_ln = pre_ln
        self.attn = MultiHeadAttention(d_model, n_head)
        self.ln_2 = nn.LayerNorm(d_model, eps=1e-5)
        self.mlp = MLP(d_model)
        self.ln_q = nn.LayerNorm(d_model, eps=1e-5)
        self.ln_kv = nn.LayerNorm(d_model, eps=1e-5)
        self.drop = nn.Dropout(dropout)

    def forward(self, q, k, v):
        if self.pre_ln:
            x = q + self.drop(self.attn(self.ln_q(q), self.ln_kv(k), self.ln_kv(v)))
        else:
            x = q + self.drop(self.attn(q, k, v))
        return x + self.drop(self.mlp(self.ln_2(x)))


class MAEncoder(nn.Module):
    """Motion-anchor encoder: ``layers`` cross-attention blocks, queries =
    first-frame tokens, keys/values = text embeddings."""

    def __init__(self, layers: int = 1, d_model: int = 512, dropout: float = 0.0,
                 pre_ln: bool = False):
        super().__init__()
        self.blocks = nn.ModuleList(
            CrossAttentionBlock(d_model, d_model // 32, dropout=dropout, pre_ln=pre_ln)
            for _ in range(layers))

    def forward(self, x, kv):
        for block in self.blocks:
            x = block(x, kv, kv)
        return x


class _TorchStyleEncoderLayer(nn.Module):
    """Post-LN encoder layer of ``torch.nn.TransformerEncoderLayer`` (exact
    gelu MLP), ``dropout`` on the attention weights, both residual branches
    and the MLP's hidden layer in train mode."""

    def __init__(self, width: int, n_head: int, dropout: float = 0.0):
        super().__init__()
        self.self_attn = MultiHeadAttention(width, n_head, attn_dropout=dropout)
        self.norm1 = nn.LayerNorm(width, eps=1e-5)
        self.norm2 = nn.LayerNorm(width, eps=1e-5)
        self.linear1 = nn.Linear(width, 4 * width)
        self.linear2 = nn.Linear(4 * width, width)
        self.drop = nn.Dropout(dropout)

    def forward(self, x, key_padding_mask=None):
        h = self.self_attn(x, x, x, key_padding_mask=key_padding_mask)
        x = self.norm1(x + self.drop(h))
        if self.linear1.weight.shape[0] != self.linear1.out_features:  # a tensor-parallel split
            h = self.drop(F.gelu(tp.column_linear(x, self.linear1.weight, self.linear1.bias)))
            h = tp.row_linear(h, self.linear2.weight, self.linear2.bias)
        else:
            h = self.linear2(self.drop(F.gelu(self.linear1(x))))
        return self.norm2(x + self.drop(h))


class _EncoderStack(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class TransformerTextEncoder(nn.Module):
    """Token + position embeddings -> LN -> dropout -> zero pad positions ->
    post-LN encoder stack with key-padding mask -> final LN -> projection."""

    def __init__(self, vocab_size: int = 30, transformer_width: int = 512,
                 transformer_layers: int = 2, output_dim: int = 512,
                 context_length: int = 32, padding_idx: int = 0, dropout: float = 0.0):
        super().__init__()
        self.padding_idx = padding_idx
        self.token_embedding = nn.Embedding(vocab_size, transformer_width)
        self.positions = nn.Embedding(context_length, transformer_width)
        self.layer_norm = nn.LayerNorm(transformer_width, eps=1e-8)
        self.drop = nn.Dropout(dropout)
        self.transformer = _EncoderStack(
            _TorchStyleEncoderLayer(transformer_width, transformer_width // 32, dropout)
            for _ in range(transformer_layers))
        self.ln_text_final = nn.LayerNorm(transformer_width, eps=1e-5)
        self.text_projection = nn.Linear(transformer_width, output_dim)

    def forward(self, text: torch.Tensor) -> torch.Tensor:
        text = text.long()
        positions = torch.arange(text.shape[-1], device=text.device)[None, :]
        x = self.drop(self.layer_norm(self.token_embedding(text) + self.positions(positions)))
        token_mask = text != self.padding_idx
        x = x * token_mask[..., None].to(x.dtype)
        # positions at or after the caption length are masked in attention
        text_length = token_mask.sum(dim=-1, keepdim=True)
        caption_mask = text_length < torch.cumsum(torch.ones_like(text), dim=-1)
        for layer in self.transformer.layers:
            x = layer(x, key_padding_mask=caption_mask)
        return self.text_projection(self.ln_text_final(x))


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum() + eps)


class SpectralConv3d(nn.Conv3d):
    """A Conv3d whose kernel is divided by its top singular value, estimated
    as flax's ``nn.SpectralNorm`` (n_steps 1, eps 1e-12) does: the kernel,
    in flax's (kD, kH, kW, in, out) order, is viewed as a (-1, out) matrix
    W; every call runs one power-iteration step from the stored ``u``
    (1, out): v = l2n(u W^T), u' = l2n(v W), sigma = v W u'^T (u and v
    carry no gradient, sigma does, through W), and uses W / sigma. In train
    mode the call then stores u' and sigma in the buffers ``u`` and
    ``sigma`` (flax's ``batch_stats``); in eval mode it iterates all the
    same but stores nothing. (``torch.nn.utils.parametrizations
    .spectral_norm`` runs no iteration in eval mode, so it would disagree.)
    ``u`` starts standard normal and ``sigma`` at 1, as in flax."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.register_buffer("u", torch.randn(1, self.out_channels))
        self.register_buffer("sigma", torch.ones(()))

    def normalized_weight(self) -> torch.Tensor:
        w = self.weight
        mat = w.permute(2, 3, 4, 1, 0).reshape(-1, w.shape[0])
        with torch.no_grad():
            v = _l2_normalize(self.u.to(mat.dtype) @ mat.T)
            u = _l2_normalize(v @ mat)
        sigma = (v @ mat @ u.T)[0, 0]
        if self.training:
            with torch.no_grad():
                self.u.copy_(u)
                self.sigma.copy_(sigma)
        return w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.normalized_weight(), self.bias)


class BasicBlock3D(nn.Module):
    """3D-conv residual block of the posterior pyramid on NCDHW input:
    conv1 (strides ``(stride_t, stride, stride)``) -> GroupNorm(16) -> ReLU
    -> conv2 -> GroupNorm(16), plus a strided conv + GroupNorm on the
    residual when ``downsample``, then ReLU. Every conv is 3x3x3, padding 1,
    no bias. ``spectral`` makes conv1 and conv2 :class:`SpectralConv3d`
    (flax's ``nn.SpectralNorm``; set by no shipped config)."""

    def __init__(self, in_planes: int, out_planes: int, stride: int = 1,
                 stride_t: int = 1, downsample: bool = False, spectral: bool = False):
        super().__init__()
        strides = (stride_t, stride, stride)
        conv = SpectralConv3d if spectral else nn.Conv3d
        self.conv1 = conv(in_planes, out_planes, 3, stride=strides, padding=1, bias=False)
        self.bn1 = nn.GroupNorm(16, out_planes, eps=1e-5)
        self.conv2 = conv(out_planes, out_planes, 3, padding=1, bias=False)
        self.bn2 = nn.GroupNorm(16, out_planes, eps=1e-5)
        self.downsample = nn.Sequential(
            nn.Conv3d(in_planes, out_planes, 3, stride=strides, padding=1, bias=False),
            nn.GroupNorm(16, out_planes, eps=1e-5),
        ) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(h + residual)


class AdaIN2D(nn.Module):
    """Instance norm over (H, W) without affine, modulated by per-pixel
    gamma/beta predicted by two 3x3 convs each from a conditioning map. NHWC."""

    def __init__(self, num_features: int):
        super().__init__()
        c = num_features
        self.conv_mu = nn.Sequential(nn.Conv2d(c, c, 3, padding=1),
                                     nn.Conv2d(c, c, 3, padding=1))
        self.conv_var = nn.Sequential(nn.Conv2d(c, c, 3, padding=1),
                                      nn.Conv2d(c, c, 3, padding=1))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=(1, 2), keepdim=True)
        var = x.var(dim=(1, 2), keepdim=True, unbiased=False)
        out = (x - mean) * torch.rsqrt(var + 1e-5)
        y = y.permute(0, 3, 1, 2)
        gamma = self.conv_mu(y).permute(0, 2, 3, 1)
        beta = self.conv_var(y).permute(0, 2, 3, 1)
        return gamma * out + beta
