"""MAGE stage 2: the causal axial spatio-temporal transformer, for generation.

Port of ``mage_tpu/models/mage.py``: ``FlatAxialDecoder`` with its full
forward and the single-slot cached decode, and ``MAGECore`` with the motion
anchor and the two samplers, for discrete ids (MAGE, ``use_cids=True``) and
continuous latents (MAGE+, ``use_cids=False``). ``generate`` re-runs the
whole decoder per frame as the reference loop does; ``generate_cached``
keeps a time-major (L, B*h*w, C) K/V cache per temporal block and decodes
one slot per step, which is exact for discrete ids. The continuous head's
GroupNorm normalises over every slot of the buffer in ``generate``; in
``generate_cached`` its statistics accumulate causally over the slots
generated so far (``head_causal``), as in the JAX package.

Parameter names are the reference state-dict keys (``generate_model.*``,
``text_encoder.*``, ``ma_encoder.*``, ``conv.0.weight`` and so on). The
training forward, the posterior pyramid and the quantized KV cache come in
later slices (ROADMAP A4, A6).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mage_tpu_torch.models.layers import (
    NEG_INF,
    AdaIN2D,
    AxialAttentionBlock,
    BasicBlock3D,
    MAEncoder,
    TransformerTextEncoder,
)


GN_GROUPS = 32  # groups of the continuous head's GroupNorm


def causal_temporal_bias(length: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Additive upper-triangular mask: -1e9 above the diagonal, 0 elsewhere."""
    return torch.triu(torch.full((length, length), NEG_INF, dtype=dtype, device=device),
                      diagonal=1)


def causalizable_group_norm(x: torch.Tensor, norm: nn.GroupNorm,
                            mean: Optional[torch.Tensor] = None,
                            var: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GroupNorm of a channels-last (B, ..., C) tensor over every non-batch
    dim (torch ``nn.GroupNorm`` semantics), or with given (B, groups)
    statistics ``mean``/``var``; the normalisation runs in x's dtype."""
    c, g = x.shape[-1], norm.num_groups
    xg = x.reshape(x.shape[0], -1, g, c // g)
    if mean is None:
        mean = xg.mean(dim=(1, 3))
        var = xg.var(dim=(1, 3), unbiased=False)
    xn = (xg - mean[:, None, :, None]) * torch.rsqrt(var[:, None, :, None] + norm.eps)
    return xn.reshape(x.shape) * norm.weight + norm.bias


def group_moments(x: torch.Tensor, num_groups: int):
    """Element count, sum and sum of squares per (batch, group) of one slot
    (B, h, w, C), in f32 whatever x's dtype: the E[x^2] - E[x]^2 form cancels
    catastrophically in bf16."""
    b, c = x.shape[0], x.shape[-1]
    xg = x.reshape(b, -1, num_groups, c // num_groups).float()
    return xg.shape[1] * xg.shape[3], xg.sum(dim=(1, 3)), (xg * xg).sum(dim=(1, 3))


class FlatAxialDecoder(nn.Module):
    """``layers`` axial blocks cycling T, H, W (``i % 3``); T-blocks are
    causal. The motion anchor is pseudo-frame 0; outputs predict frames
    1..L-1: logits (``use_cids``) or continuous latents. The continuous head
    is GroupNorm -> silu -> 1x1x1 conv, keyed ``out.0`` and ``out.2``.
    ``spatial_attn`` is every block's route for its unmasked (H and W) calls
    (``AxialAttentionBlock``)."""

    def __init__(self, in_channels: int, model_channels: int, out_channels: int,
                 frames_length: int, layers: int, context_channels: Optional[int] = None,
                 use_cids: bool = True, spatial_attn: str = "flat"):
        super().__init__()
        mc = model_channels
        self.frames_length = frames_length
        self.model_channels = mc
        self.use_cids = use_cids
        self.in_linear = nn.Linear(in_channels, mc)
        self.context_linear = nn.Linear(context_channels or mc, mc)
        self.T_positional_embedding = nn.Parameter(torch.empty(frames_length, 1, 1, mc))
        self.blocks = nn.ModuleList(
            AxialAttentionBlock(mc, mc // 32, axial_dim=i % 3 + 1, spatial_attn=spatial_attn)
            for i in range(layers))
        if use_cids:
            self.out = nn.Linear(mc, out_channels)
        else:
            self.out = nn.Sequential(nn.GroupNorm(GN_GROUPS, mc, eps=1e-5), nn.SiLU(),
                                     nn.Conv3d(mc, out_channels, 1))

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """The head on (B, ..., mc); the continuous GroupNorm takes its
        statistics over all of x's non-batch dims."""
        if self.use_cids:
            return self.out(x)
        return self._out_conv(causalizable_group_norm(x, self.out[0]))

    def _out_conv(self, h: torch.Tensor) -> torch.Tensor:
        conv = self.out[2]
        return F.linear(F.silu(h), conv.weight.flatten(1), conv.bias)

    def forward(self, motion: torch.Tensor, imgs: torch.Tensor) -> torch.Tensor:
        """motion (B, h, w, Cctx); imgs (B, L-1, h, w, Cin) -> (B, L-1, h, w, out)."""
        x = torch.cat([self.context_linear(motion)[:, None], self.in_linear(imgs)], dim=1)
        x = x + self.T_positional_embedding
        bias = causal_temporal_bias(self.frames_length, x.dtype, x.device)
        for i, block in enumerate(self.blocks):
            x = block(x, attn_bias=bias if i % 3 == 0 else None)
        return self.head(x[:, 1:])

    def init_cache(self, batch: int, h: int, w: int, dtype, device) -> dict:
        """Empty time-major (L, B*h*w, C) K/V caches, one pair per T-block."""
        shape = (self.frames_length, batch * h * w, self.model_channels)
        return {
            f"layer_{i}": (torch.zeros(shape, dtype=dtype, device=device),
                           torch.zeros(shape, dtype=dtype, device=device))
            for i in range(len(self.blocks)) if i % 3 == 0
        }

    def decode_slot(self, slot: torch.Tensor, pos: int, cache: dict,
                    is_anchor: bool = False) -> torch.Tensor:
        """One temporal slot (B, h, w, C_in or C_ctx) through every block,
        extending the caches at ``pos`` in place -> trunk (B, h, w, mc)."""
        x = self.context_linear(slot) if is_anchor else self.in_linear(slot)
        x = x + self.T_positional_embedding[pos]
        for i, block in enumerate(self.blocks):
            if i % 3 == 0:
                k, v = cache[f"layer_{i}"]
                x = block.incremental_temporal(x, k, v, pos)
            else:
                x = block.single_slot_spatial(x)
        return x

    def head_slot(self, x: torch.Tensor) -> torch.Tensor:
        """Discrete head on one trunk slot (B, h, w, mc) -> logits."""
        return self.out(x)

    def init_gn_state(self, batch: int, device) -> tuple:
        """Zero (count, sum, sum of squares) per (batch, group) for the
        causal GroupNorm statistics of the continuous head, in f32."""
        zeros = torch.zeros(batch, GN_GROUPS, dtype=torch.float32, device=device)
        return 0, zeros, zeros.clone()

    def head_causal(self, x: torch.Tensor, gn_state: tuple):
        """Continuous head on one trunk slot (B, h, w, mc) with GroupNorm
        statistics over every slot generated so far, this one included ->
        (latents (B, h, w, out), new state). The moments reduce in f32; the
        normalisation runs in x's dtype."""
        count, s, ss = gn_state
        n, s1, ss1 = group_moments(x, GN_GROUPS)
        count, s, ss = count + n, s + s1, ss + ss1
        mean = s / count
        var = torch.clamp(ss / count - mean * mean, min=0.0)
        h = causalizable_group_norm(x, self.out[0], mean.to(x.dtype), var.to(x.dtype))
        return self._out_conv(h), (count, s, ss)


class MAGECore(nn.Module):
    """The stage-2 model, eval mode: discrete MAGE (``use_cids=True``, ids
    embedded by ``visual_token_embedding``) or MAGE+ (continuous latents of
    ``embed_dim`` channels projected by it, with ``pre_ln`` cross-attention).
    ``spatial_attn`` ("flat" or "fusedblock") goes to the decoder's blocks."""

    def __init__(self, codebook_size: int, frames_length: int, image_resolution: int,
                 vision_width: int, randomness: bool = False, use_cids: bool = True,
                 pre_ln: bool = False, embed_dim: int = 4,
                 text_vocab_size: int = 30, text_context_length: int = 32,
                 text_width: int = 512, text_layers: int = 2, text_output_dim: int = 512,
                 text_padding_idx: int = 0, ma_layers: int = 1, ma_d_model: int = 512,
                 dec_layers: int = 6, dec_out_channels: int = 512,
                 spatial_attn: str = "flat"):
        super().__init__()
        w, r = vision_width, image_resolution
        self.codebook_size = codebook_size
        self.frames_length = frames_length
        self.image_resolution = r
        self.randomness = randomness
        self.use_cids = use_cids
        self.pre_ln = pre_ln
        if use_cids:
            self.visual_token_embedding = nn.Embedding(codebook_size, w)
        else:
            self.visual_token_embedding = nn.Linear(embed_dim, w)
        # a Sequential so the stem conv is keyed ``conv.0`` as in the reference
        self.conv = nn.Sequential(nn.Conv2d(w, w, 3, padding=1, bias=False))
        self.speed_embedding = nn.Parameter(torch.empty(1, w))
        self.H_positional_embedding = nn.Parameter(torch.empty(1, r, 1, w))
        self.W_positional_embedding = nn.Parameter(torch.empty(1, 1, r, w))
        self.text_encoder = TransformerTextEncoder(
            vocab_size=text_vocab_size, transformer_width=text_width,
            transformer_layers=text_layers, output_dim=text_output_dim,
            context_length=text_context_length, padding_idx=text_padding_idx)
        self.ma_encoder = MAEncoder(layers=ma_layers, d_model=ma_d_model, pre_ln=pre_ln)
        self.generate_model = FlatAxialDecoder(
            in_channels=w, model_channels=ma_d_model, out_channels=dec_out_channels,
            frames_length=frames_length, layers=dec_layers, context_channels=ma_d_model,
            use_cids=use_cids, spatial_attn=spatial_attn)
        if randomness:
            self.conv3d = nn.ModuleList([
                BasicBlock3D(w, w), BasicBlock3D(w, w), BasicBlock3D(w, w),
                BasicBlock3D(w, ma_d_model)])
            self.conv_mu2 = nn.Conv2d(ma_d_model, 64, 3, padding=1)
            self.conv_var2 = nn.Conv2d(ma_d_model, 64, 3, padding=1)
            self.conv_d2 = nn.Conv2d(64, w, 3, padding=1, bias=False)
            self.adain = AdaIN2D(w)

    # ---- pieces -----------------------------------------------------------

    def embed_latents(self, x: torch.Tensor) -> torch.Tensor:
        """ids (B, L, h, w) or continuous (B, L, h, w, c) -> (B, L, h, w, width)."""
        if self.use_cids:
            return self.visual_token_embedding(x.long())
        return self.visual_token_embedding(x)

    def stem(self, x_emb: torch.Tensor) -> torch.Tensor:
        """Per-frame 3x3 conv + separable H/W positional embeddings,
        (B, L', h, w, C) -> same."""
        b, l, h, w, c = x_emb.shape
        frames = x_emb.reshape(b * l, h, w, c).permute(0, 3, 1, 2)
        out = self.conv(frames).permute(0, 2, 3, 1).reshape(b, l, h, w, c)
        return out + self.H_positional_embedding + self.W_positional_embedding

    def compute_motion_anchor(self, first_tokens: torch.Tensor, text_emb: torch.Tensor,
                              video_emb: Optional[torch.Tensor],
                              speed: Optional[torch.Tensor]) -> torch.Tensor:
        b = first_tokens.shape[0]
        r = self.image_resolution
        anchor = self.ma_encoder(first_tokens, text_emb).reshape(b, r, r, -1)
        if self.randomness:
            cond = self.conv_d2(video_emb.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            anchor = self.adain(anchor, cond)
        if speed is not None:
            speed_emb = speed.reshape(b, 1).to(anchor.dtype) @ self.speed_embedding
            anchor = anchor + speed_emb[:, None, None, :]
        return anchor

    def _prepare_generation(self, latents0, text, speed, video_noise, generator):
        x_emb0 = self.embed_latents(latents0)  # (B, 1, h, w, C)
        b, _, h, w, c = x_emb0.shape
        first_tokens = self.stem(x_emb0)[:, 0].reshape(b, -1, c)
        text_emb = self.text_encoder(text)
        video_emb = None
        if self.randomness:
            if video_noise is None:
                gen_device = generator.device if generator is not None else x_emb0.device
                video_noise = torch.randn((b, h, w, 64), generator=generator,
                                          device=gen_device, dtype=x_emb0.dtype)
            video_emb = video_noise.to(device=x_emb0.device, dtype=x_emb0.dtype)
        anchor = self.compute_motion_anchor(first_tokens, text_emb, video_emb, speed)
        return x_emb0, anchor

    # ---- samplers ----------------------------------------------------------

    @torch.no_grad()
    def generate(self, latents0: torch.Tensor, text: torch.Tensor,
                 speed: Optional[torch.Tensor] = None,
                 video_noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Greedy frame-by-frame generation that re-runs the full decoder per
        frame over a buffer pre-filled with the first frame's embedding (the
        reference loop). ``latents0`` (B, 1, h, w[, c]) -> ids (B, L-1, h, w)
        or continuous latents (B, L-1, h, w, c)."""
        x_emb0, anchor = self._prepare_generation(latents0, text, speed, video_noise,
                                                  generator)
        b, _, h, w, c = x_emb0.shape
        l1 = self.frames_length - 1
        buf = x_emb0.expand(b, l1, h, w, c).clone()
        prediction = None
        for i in range(l1):
            prediction = self.generate_model(anchor, self.stem(buf))
            if i + 1 < l1:
                frame = prediction[:, i]
                if self.use_cids:
                    frame = torch.argmax(frame, dim=-1)
                buf[:, i + 1] = self.embed_latents(frame)
        if not self.use_cids:
            return prediction
        return torch.argmax(prediction, dim=-1).to(torch.int32)

    @torch.no_grad()
    def generate_cached(self, latents0: torch.Tensor, text: torch.Tensor,
                        speed: Optional[torch.Tensor] = None,
                        video_noise: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None,
                        temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
        """KV-cached generation: one single-slot decoder pass per frame.
        ``temperature`` > 0 samples ids from softmax(logits / temperature),
        restricted to the ``top_k`` largest logits when 0 < top_k < K, with
        ``generator``; 0 is the exact greedy argmax. ``latents0``
        (B, 1, h, w[, c]) -> ids (B, L-1, h, w) or continuous latents
        (B, L-1, h, w, c), whose head normalises with causal statistics."""
        if temperature > 0 and not self.use_cids:
            raise ValueError("temperature sampling only applies to the discrete head")
        x_emb0, anchor = self._prepare_generation(latents0, text, speed, video_noise,
                                                  generator)
        b, _, h, w, c = x_emb0.shape
        decoder = self.generate_model
        cache = decoder.init_cache(b, h, w, x_emb0.dtype, x_emb0.device)
        decoder.decode_slot(anchor, 0, cache, is_anchor=True)
        slot = self.stem(x_emb0)[:, 0]  # frame 0 goes in at slot 1
        gn_state = None if self.use_cids else decoder.init_gn_state(b, x_emb0.device)
        frames = []
        for pos in range(1, self.frames_length):
            trunk = decoder.decode_slot(slot, pos, cache)
            if not self.use_cids:
                frame, gn_state = decoder.head_causal(trunk, gn_state)
            elif temperature > 0:
                frame = self._sample(decoder.head_slot(trunk), temperature, top_k, generator)
            else:
                frame = torch.argmax(decoder.head_slot(trunk), dim=-1).to(torch.int32)
            frames.append(frame)
            if pos + 1 < self.frames_length:
                slot = self.stem(self.embed_latents(frame)[:, None])[:, 0]
        return torch.stack(frames, dim=1)

    def _sample(self, logits, temperature, top_k, generator):
        logits = logits.float() / temperature
        if 0 < top_k < self.codebook_size:
            kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
            logits = torch.where(logits < kth, NEG_INF, logits)
        probs = torch.softmax(logits, dim=-1).reshape(-1, logits.shape[-1])
        ids = torch.multinomial(probs, 1, generator=generator)
        return ids.reshape(logits.shape[:-1]).to(torch.int32)
