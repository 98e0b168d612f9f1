"""MAGE stage 2: the causal axial spatio-temporal transformer.

Port of ``mage_tpu/models/mage.py``: ``FlatAxialDecoder`` with its full
forward and the single-slot cached decode, and ``MAGECore`` with the
teacher-forced loss forward (the 3D-conv posterior pyramid, the KL and
speed terms), the motion anchor and the two samplers, for discrete ids
(MAGE, ``use_cids=True``) and continuous latents (MAGE+,
``use_cids=False``). ``generate`` re-runs the whole decoder per frame as the
reference loop does; ``generate_cached`` keeps a time-major (L, B*h*w, C)
K/V cache per temporal block and decodes one slot per step, which is exact
for discrete ids. The continuous head's GroupNorm normalises over every slot
of the buffer in ``generate``; in ``generate_cached`` its statistics
accumulate causally over the slots generated so far (``head_causal``), as in
the JAX package. On the card a greedy ``generate_cached`` replays the whole
cached sampler as one CUDA graph for its shape (``models/graphs.py``). The
samplers always run in eval mode; the loss forward runs in the module's mode
(dropout in train mode).

Parameter names are the reference state-dict keys (``generate_model.*``,
``text_encoder.*``, ``ma_encoder.*``, ``conv.0.weight`` and so on).
``kv_quant="int8"|"int4"`` (the JAX package's ``MAGE_KV_QUANT``) stores the
cached sampler's K/V as int8 codes with per-(slot, head) f32 scales.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from mage_tpu_torch.models.layers import (
    NEG_INF,
    AdaIN2D,
    AxialAttentionBlock,
    BasicBlock3D,
    MAEncoder,
    TransformerTextEncoder,
    lecun_normal_,
)
from mage_tpu_torch.models import graphs
from mage_tpu_torch.utils import trace


GN_GROUPS = 32  # groups of the continuous head's GroupNorm
KV_QUANT = {None: None, "int8": 8, "int4": 4}  # kv_quant -> code bits


def causal_temporal_bias(length: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Additive upper-triangular mask: -1e9 above the diagonal, 0 elsewhere."""
    return torch.triu(torch.full((length, length), NEG_INF, dtype=dtype, device=device),
                      diagonal=1)


def standard_normal(noise: Optional[torch.Tensor], shape, like: torch.Tensor,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
    """``noise`` if given, else a standard-normal draw of ``shape`` from
    ``generator`` (on the generator's device), either way on ``like``'s
    device and in its dtype."""
    if noise is None:
        gen_device = generator.device if generator is not None else like.device
        noise = torch.randn(shape, generator=generator, device=gen_device, dtype=like.dtype)
    return noise.to(device=like.device, dtype=like.dtype)


def on_card(t: torch.Tensor) -> bool:
    """A plain tensor on a CUDA device (not a sharded ``DTensor``)."""
    return t.is_cuda and type(t) is torch.Tensor


def _in_eval_mode(sampler):
    """Run ``sampler`` in eval mode and give the module back its mode after:
    generation never drops out, as JAX's samplers pass ``train=False``."""

    @functools.wraps(sampler)
    def run(self, *args, **kwargs):
        was_training = self.training
        self.eval()
        try:
            return sampler(self, *args, **kwargs)
        finally:
            self.train(was_training)

    return run


def rematerialized(module: nn.Module, *args):
    """``module(*args)``, its activations recomputed in the backward pass
    (``torch.utils.checkpoint``). The parameters the module holds now go in
    as explicit inputs: under ``functional_call`` (the train step's bf16
    copies) they are the copies, which the recompute must see too."""
    names, tensors = zip(*module.named_parameters())

    def run(*flat):
        return functional_call(module, dict(zip(names, flat[len(args):])), flat[:len(args)])

    return checkpoint(run, *args, *tensors, use_reentrant=False)


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


def check_kv_quant(kv_quant: Optional[str], d_model: int, n_head: int) -> None:
    """Unknown ``kv_quant`` values raise, as JAX's ``MAGE_KV_QUANT`` does; so
    does a quantized cache whose head width is not 32, where JAX's
    ``model_channels // 32`` scale columns would not be one per head."""
    if kv_quant not in KV_QUANT:
        raise ValueError(f"kv_quant must be None, 'int8' or 'int4', got {kv_quant!r}")
    if kv_quant is not None and (n_head < 1 or d_model != 32 * n_head):
        raise ValueError(f"kv_quant={kv_quant!r} needs heads of width 32; d_model "
                         f"{d_model} with {n_head} heads")


class FlatAxialDecoder(nn.Module):
    """``layers`` axial blocks cycling T, H, W (``i % 3``); T-blocks are
    causal. The motion anchor is pseudo-frame 0; outputs predict frames
    1..L-1: logits (``use_cids``) or continuous latents. The continuous head
    is GroupNorm -> silu -> 1x1x1 conv, keyed ``out.0`` and ``out.2``.
    ``spatial_attn`` is every block's eval-mode route for its unmasked (H
    and W) calls (``AxialAttentionBlock``). ``remat`` recomputes each block's
    activations in the backward pass (``torch.utils.checkpoint``) in train
    mode. ``kv_quant`` (None, "int8" or "int4") makes ``init_cache`` hold
    quantized K/V (``check_kv_quant``)."""

    def __init__(self, in_channels: int, model_channels: int, out_channels: int,
                 frames_length: int, layers: int, context_channels: Optional[int] = None,
                 use_cids: bool = True, spatial_attn: str = "flat", dropout: float = 0.0,
                 remat: bool = False, kv_quant: Optional[str] = None):
        super().__init__()
        mc = model_channels
        check_kv_quant(kv_quant, mc, mc // 32)
        self.kv_quant = kv_quant
        self.frames_length = frames_length
        self.model_channels = mc
        self.use_cids = use_cids
        self.remat = remat
        self.in_linear = nn.Linear(in_channels, mc)
        self.context_linear = nn.Linear(context_channels or mc, mc)
        self.T_positional_embedding = nn.Parameter(torch.empty(frames_length, 1, 1, mc))
        self.blocks = nn.ModuleList(
            AxialAttentionBlock(mc, mc // 32, axial_dim=i % 3 + 1, spatial_attn=spatial_attn,
                                dropout=dropout)
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
            block_bias = bias if i % 3 == 0 else None
            if self.remat and self.training:
                x = rematerialized(block, x, block_bias)
            else:
                x = block(x, attn_bias=block_bias)
        return self.head(x[:, 1:])

    def init_cache(self, batch: int, h: int, w: int, dtype, device) -> dict:
        """Empty time-major (L, B*h*w, C) K/V caches, one entry per T-block:
        a (k, v) pair in ``dtype``, or with ``kv_quant`` a 4-tuple (k codes,
        v codes, k scales, v scales) of int8 (L, B*h*w, C) and f32
        (L, n_head) tensors. JAX sizes the scales ``model_channels // 32``;
        here they follow the blocks' heads, which ``check_kv_quant`` holds
        at width 32."""
        n_head = self.blocks[0].n_head
        check_kv_quant(self.kv_quant, self.model_channels, n_head)
        shape = (self.frames_length, batch * h * w, self.model_channels)
        if self.kv_quant is not None:
            sshape = (self.frames_length, n_head)
            return {
                f"layer_{i}": (torch.zeros(shape, dtype=torch.int8, device=device),
                               torch.zeros(shape, dtype=torch.int8, device=device),
                               torch.zeros(sshape, dtype=torch.float32, device=device),
                               torch.zeros(sshape, dtype=torch.float32, device=device))
                for i in range(len(self.blocks)) if i % 3 == 0
            }
        return {
            f"layer_{i}": (torch.zeros(shape, dtype=dtype, device=device),
                           torch.zeros(shape, dtype=dtype, device=device))
            for i in range(len(self.blocks)) if i % 3 == 0
        }

    def decode_slot(self, slot: torch.Tensor, pos: int, cache: dict,
                    is_anchor: bool = False) -> torch.Tensor:
        """One temporal slot (B, h, w, C_in or C_ctx) through every block,
        extending the caches at ``pos`` in place -> trunk (B, h, w, mc).
        ``kv_quant`` alone picks the attention; a cache that ``init_cache``
        made under another ``kv_quant`` raises."""
        bits = KV_QUANT[self.kv_quant]
        with trace.span("mage.slot", pos=pos):
            x = self.context_linear(slot) if is_anchor else self.in_linear(slot)
            x = x + self.T_positional_embedding[pos]
            for i, block in enumerate(self.blocks):
                if i % 3 == 0:
                    entry = cache[f"layer_{i}"]
                    if len(entry) != (2 if bits is None else 4):
                        raise ValueError(f"a cache of {len(entry)}-tuples under kv_quant="
                                         f"{self.kv_quant!r}: make it with init_cache")
                    if bits is not None:
                        x = block.incremental_temporal_quant(x, *entry, pos, bits=bits)
                    else:
                        x = block.incremental_temporal(x, *entry, pos)
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
    """All trainable stage-2 state: discrete MAGE (``use_cids=True``, ids
    embedded by ``visual_token_embedding``) or MAGE+ (continuous latents of
    ``embed_dim`` channels projected by it, with ``pre_ln`` cross-attention).
    ``spatial_attn`` ("flat" or "fusedblock") goes to the decoder's blocks,
    ``kv_quant`` (None, "int8" or "int4") to its cache.

    Training fields as in JAX: ``dropout`` (the decoder's and the motion
    anchor's; ``text_dropout`` the text encoder's), ``remat`` (recompute the
    axial blocks and the posterior's 3D-conv blocks in the backward pass),
    and the opt-in loss weights: ``motion_loss_weight`` scales each target
    token's loss by 1 + weight * moved(token), ``early_loss_weight`` the
    first ``early_loss_frames`` predicted frames' by 1 + weight, both
    normalised to mean 1 (0 = the reference's uniform loss)."""

    def __init__(self, codebook_size: int, frames_length: int, image_resolution: int,
                 vision_width: int, randomness: bool = False, use_cids: bool = True,
                 pre_ln: bool = False, embed_dim: int = 4, dropout: float = 0.0,
                 remat: bool = False, motion_loss_weight: float = 0.0,
                 early_loss_weight: float = 0.0, early_loss_frames: int = 3,
                 text_vocab_size: int = 30, text_context_length: int = 32,
                 text_width: int = 512, text_layers: int = 2, text_output_dim: int = 512,
                 text_padding_idx: int = 0, text_dropout: float = 0.0,
                 ma_layers: int = 1, ma_d_model: int = 512,
                 dec_layers: int = 6, dec_out_channels: int = 512,
                 spatial_attn: str = "flat", kv_quant: Optional[str] = None,
                 text_encoder_cls: Optional[type] = None,
                 text_encoder_params: Optional[dict] = None,
                 ma_cls: Optional[type] = None, ma_params: Optional[dict] = None,
                 decoder_cls: Optional[type] = None, decoder_params: Optional[dict] = None):
        super().__init__()
        w, r = vision_width, image_resolution
        self.codebook_size = codebook_size
        self.frames_length = frames_length
        self.image_resolution = r
        self.randomness = randomness
        self.use_cids = use_cids
        self.pre_ln = pre_ln
        self.remat = remat
        self.motion_loss_weight = motion_loss_weight
        self.early_loss_weight = early_loss_weight
        self.early_loss_frames = early_loss_frames
        if use_cids:
            self.visual_token_embedding = nn.Embedding(codebook_size, w)
        else:
            self.visual_token_embedding = nn.Linear(embed_dim, w)
        # a Sequential so the stem conv is keyed ``conv.0`` as in the reference
        self.conv = nn.Sequential(nn.Conv2d(w, w, 3, padding=1, bias=False))
        self.speed_embedding = nn.Parameter(torch.empty(1, w))
        self.H_positional_embedding = nn.Parameter(torch.empty(1, r, 1, w))
        self.W_positional_embedding = nn.Parameter(torch.empty(1, 1, r, w))
        if text_encoder_cls is not None:
            self.text_encoder = text_encoder_cls(**dict(text_encoder_params or {}))
        else:
            self.text_encoder = TransformerTextEncoder(
                vocab_size=text_vocab_size, transformer_width=text_width,
                transformer_layers=text_layers, output_dim=text_output_dim,
                context_length=text_context_length, padding_idx=text_padding_idx,
                dropout=text_dropout)
        if ma_cls is not None:
            # the reference merges {'dropout'} into the MA config (mage_model.py:475)
            self.ma_encoder = ma_cls(**{"dropout": dropout, **dict(ma_params or {})})
        else:
            self.ma_encoder = MAEncoder(layers=ma_layers, d_model=ma_d_model, dropout=dropout,
                                        pre_ln=pre_ln)
        if decoder_cls is not None:
            # and {'use_cids', 'dropout', 'context_channels'} into the
            # decoder's (mage_model.py:476-477)
            self.generate_model = decoder_cls(**{
                "use_cids": use_cids, "dropout": dropout, "context_channels": ma_d_model,
                **dict(decoder_params or {})})
        else:
            self.generate_model = FlatAxialDecoder(
                in_channels=w, model_channels=ma_d_model, out_channels=dec_out_channels,
                frames_length=frames_length, layers=dec_layers, context_channels=ma_d_model,
                use_cids=use_cids, spatial_attn=spatial_attn, dropout=dropout, remat=remat,
                kv_quant=kv_quant)
        if randomness:
            self.conv3d = nn.ModuleList(
                BasicBlock3D(w, out, stride=1, stride_t=2, downsample=True)
                for out in (w, w, w, ma_d_model))
            self.conv_mu2 = nn.Conv2d(ma_d_model, 64, 3, padding=1)
            self.conv_var2 = nn.Conv2d(ma_d_model, 64, 3, padding=1)
            self.conv_d2 = nn.Conv2d(64, w, 3, padding=1, bias=False)
            self.adain = AdaIN2D(w)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX core's distributions where they are not
        ``pipeline.init_weights``' (which calls this after its pass, whose
        draws for these tensors they replace): the decoder blocks' CLIP-style
        scales (attention width^-0.5, projections width^-0.5 (2 layers)^-0.5,
        MLP input (2 width)^-0.5; ``mage_tpu/models/mage.py:117-128``), LeCun
        normals for the decoder's input, context and discrete head layers
        (flax's default ``nn.Dense``) and for the 2D convs (flax's default
        ``nn.Conv``), and He normals over fan-out for the posterior's 3D
        convs. A sub-component of a config-chosen class with an
        ``init_weights(generator)`` method (the BERT head) draws its own."""

        def normal_(p, std):
            p.copy_(torch.randn(p.shape, generator=generator) * std)

        dec = self.generate_model
        if isinstance(dec, FlatAxialDecoder):
            mc = dec.model_channels
            attn_std, fc_std = mc ** -0.5, (2 * mc) ** -0.5
            proj_std = mc ** -0.5 * (2 * len(dec.blocks)) ** -0.5
            for block in dec.blocks:
                normal_(block.attn.in_proj_weight, attn_std)
                normal_(block.attn.out_proj.weight, proj_std)
                normal_(block.mlp.c_fc.weight, fc_std)
                normal_(block.mlp.c_proj.weight, proj_std)
            for lin in [dec.in_linear, dec.context_linear] + ([dec.out] if dec.use_cids else []):
                lecun_normal_(lin.weight, generator)
        for part in (self.text_encoder, self.ma_encoder, dec):
            if hasattr(part, "init_weights"):
                part.init_weights(generator)
        for name, m in self.named_modules():
            if isinstance(m, nn.Conv3d) and name.startswith("conv3d."):
                normal_(m.weight, (2.0 / (m.weight.shape[0] * m.weight[0, 0].numel())) ** 0.5)
            elif isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, generator)

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

    def _early_frame_weight(self, n_frames: int, device) -> torch.Tensor:
        """(1, n_frames, 1, 1) f32 per-frame loss multiplier: the first
        ``early_loss_frames`` predicted frames get 1 + early_loss_weight."""
        t = torch.arange(n_frames, device=device)
        wf = torch.where(t < self.early_loss_frames, 1.0 + self.early_loss_weight, 1.0)
        return wf.to(torch.float32)[None, :, None, None]

    def video_posterior(self, x_emb: torch.Tensor):
        """The 3D-conv pyramid over the whole embedded video -> (mu, logvar),
        (B, L, h, w, C) -> two (B, h, w, 64). Each stride-2 block halves T;
        a T left above 1 (clips longer than 16 frames) is mean-pooled. Under
        ``remat`` in train mode each block is recomputed in the backward
        pass."""
        h = x_emb.permute(0, 4, 1, 2, 3)  # NCDHW view of channels-last memory
        for block in self.conv3d:
            if self.remat and self.training:
                h = rematerialized(block, h)
            else:
                h = block(h)
        h = h.mean(dim=2) if h.shape[2] > 1 else h.squeeze(2)
        return (self.conv_mu2(h).permute(0, 2, 3, 1),
                self.conv_var2(h).permute(0, 2, 3, 1))

    def speed_l2(self, speed: torch.Tensor) -> torch.Tensor:
        """The alpha regulariser: mean ||speed * speed_embedding||^2, in f32."""
        emb = (speed.reshape(-1, 1).to(self.speed_embedding.dtype)
               @ self.speed_embedding).float()
        return (emb * emb).sum(dim=-1).mean()

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

    # ---- training forward ----------------------------------------------------

    def forward(self, latents: torch.Tensor, text: torch.Tensor,
                speed: Optional[torch.Tensor] = None, test_flag: bool = False,
                context_latents: Optional[torch.Tensor] = None,
                posterior_noise: Optional[torch.Tensor] = None,
                video_noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> dict:
        """Teacher-forced forward -> raw loss terms: ``prediction`` (token
        cross-entropy for ids, MSE for continuous latents), ``kl_loss`` (the
        stochastic branch) and ``speed_l2`` (when ``speed`` is given), each
        reduced in f32, and ``predict``, the decoder's output. The beta and
        alpha weighting happens in the train step.

        ``posterior_noise`` (B, h, w, 64) is the posterior sample's standard
        normal draw; ``test_flag`` samples the prior instead, from
        ``video_noise``. What is not given is drawn from ``generator``.
        ``context_latents`` (optional) feed the decoder's context while the
        targets, the posterior and the motion weights stay on ``latents``."""
        x_emb = self.embed_latents(latents)
        b = x_emb.shape[0]
        l1 = self.frames_length - 1
        ctx_emb = x_emb if context_latents is None else self.embed_latents(context_latents)
        prior_img = self.stem(ctx_emb[:, :l1])
        first_tokens = prior_img[:, 0].reshape(b, -1, x_emb.shape[-1])
        text_emb = self.text_encoder(text)

        video_emb = mu = logvar = None
        if self.randomness:
            mu, logvar = self.video_posterior(x_emb)
            eps = standard_normal(posterior_noise, logvar.shape, logvar, generator)
            video_emb = mu + eps * torch.exp(0.5 * logvar)
            if test_flag:  # prior sampling at test time
                video_emb = standard_normal(video_noise, logvar.shape, logvar, generator)

        anchor = self.compute_motion_anchor(first_tokens, text_emb, video_emb, speed)
        predict = self.generate_model(anchor, prior_img)

        # loss reductions run in f32 whatever the compute dtype
        weighted = self.motion_loss_weight > 0 or self.early_loss_weight > 0
        if self.use_cids:
            labels = latents[:, 1:self.frames_length].long()
            logits = predict.reshape(-1, self.codebook_size).float()
            tok_ce = F.cross_entropy(logits, labels.reshape(-1), reduction="none")
            if weighted:
                w = torch.ones(labels.shape, dtype=torch.float32, device=logits.device)
                if self.motion_loss_weight > 0:
                    moved = (labels != latents[:, :l1].long()).float()
                    w = w * (1.0 + self.motion_loss_weight * moved)
                w = w * self._early_frame_weight(labels.shape[1], w.device)
                recon = (tok_ce * (w / w.mean()).reshape(-1)).mean()
            else:
                recon = tok_ce.mean()
        else:
            target = latents[:, 1:self.frames_length].float()
            diff = predict.float() - target
            if weighted:
                w = torch.ones(target.shape[:-1], dtype=torch.float32, device=target.device)
                if self.motion_loss_weight > 0:
                    d2 = ((target - latents[:, :l1].float()) ** 2).mean(dim=-1)
                    w = w * (1.0 + self.motion_loss_weight * d2 / (d2.mean() + 1e-8))
                w = w * self._early_frame_weight(target.shape[1], w.device)
                recon = ((diff ** 2).mean(dim=-1) * (w / w.mean())).mean()
            else:
                recon = (diff ** 2).mean()

        out = {"prediction": recon, "predict": predict}
        if self.randomness:
            mu_f = mu.reshape(b, -1).float()
            logvar_f = logvar.reshape(b, -1).float()
            out["kl_loss"] = -0.5 * (1 + logvar_f - mu_f ** 2 - torch.exp(logvar_f)).sum(1).mean()
        if speed is not None:
            out["speed_l2"] = self.speed_l2(speed)
        return out

    def _prepare_generation(self, latents0, text, speed, video_noise, generator):
        x_emb0 = self.embed_latents(latents0)  # (B, 1, h, w, C)
        b, _, h, w, c = x_emb0.shape
        first_tokens = self.stem(x_emb0)[:, 0].reshape(b, -1, c)
        text_emb = self.text_encoder(text)
        video_emb = None
        if self.randomness:
            video_emb = standard_normal(video_noise, (b, h, w, 64), x_emb0, generator)
        anchor = self.compute_motion_anchor(first_tokens, text_emb, video_emb, speed)
        return x_emb0, anchor

    # ---- samplers ----------------------------------------------------------

    @torch.no_grad()
    @_in_eval_mode
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
        (B, L-1, h, w, c), whose head normalises with causal statistics.

        A greedy call on the card by a core in eval mode (``graphable``)
        runs the whole sampler, from the motion anchor to the stacked
        frames, as one CUDA graph for its shape (``models/graphs.py``): the
        first call of a shape runs the eager loop, the second captures it,
        later ones replay it, bit-equal to the loop. The prior sample, when
        not given, is drawn before the replay as the loop draws it."""
        if temperature > 0 and not self.use_cids:
            raise ValueError("temperature sampling only applies to the discrete head")
        if not (temperature == 0 and self.graphable(latents0)):
            return self._cached_loop(latents0, text, speed, video_noise, generator,
                                     temperature, top_k)
        if not self.randomness:
            video_noise = None
        elif video_noise is None:  # the loop's draw: the embedding's dtype and device
            video_noise = standard_normal(None, (latents0.shape[0], *latents0.shape[2:4], 64),
                                          self.visual_token_embedding.weight, generator)
        dec = self.generate_model
        route = tuple(block.spatial_attn for block in dec.blocks)
        return graphs.call(self, self._cached_loop, (latents0, text, speed, video_noise),
                           route)

    def graphable(self, latents0: torch.Tensor) -> bool:
        """Whether ``generate_cached`` replays a CUDA graph for this call:
        ``latents0`` on the card, the core in eval mode, the port's own
        decoder over an unquantized cache (the quantized attention makes a
        host-to-device copy a slot) and the port's own text and motion-anchor
        encoders (a config-chosen class from elsewhere may read the device
        from the host). The rest runs the eager loop."""
        dec = self.generate_model
        return (on_card(latents0) and not self.training
                and isinstance(dec, FlatAxialDecoder) and dec.kv_quant is None
                and all(type(m).__module__.startswith("mage_tpu_torch.")
                        for m in (self.text_encoder, self.ma_encoder)))

    @_in_eval_mode
    def _cached_loop(self, latents0, text, speed=None, video_noise=None, generator=None,
                     temperature=0.0, top_k=0) -> torch.Tensor:
        """The cached sampler's eager loop (``generate_cached``)."""
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
