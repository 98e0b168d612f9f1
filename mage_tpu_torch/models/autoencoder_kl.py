"""KL-regularised autoencoder: the MAGE+ first stage.

Port of ``mage_tpu/models/autoencoder_kl.py`` (the ldm ``AutoencoderKL``):
a ResNet encoder and decoder with GroupNorm + SiLU, a mid attention block,
and the ``DiagonalGaussian`` posterior. Activations are NHWC, as in the JAX
package; 3x3 convs run on the NCHW view of an NHWC tensor (channels-last
memory), 1x1 convs as linear maps over the channel axis.

At inference every decoder ``ResnetBlock`` sends both of its
``GroupNorm -> silu -> conv3x3`` chains through ``ops.gn_silu_conv3x3``
(the hand-written kernel on a CUDA tensor). The encoder, and any block in
train mode, keep the plain ``nn.GroupNorm -> silu -> nn.Conv2d`` chain, so
the training ``forward`` (``training/autoencoder_kl_trainer.py``) launches
no kernel.

The decoder's ``conv3x3(nearest_up2(x))`` is the JAX package's default
``MAGE_KL_UP=dilated`` form: the upsample folded into one 4x4 transposed
conv of stride 2 with the weight of the 3x3 ``conv``.

Parameter names are the ldm state-dict keys (``encoder.down.{i}.block.{j}``,
``decoder.up.{i}.upsample.conv``, ``quant_conv``, ...), so the released ldm
kl-f8 weights and ``compat.from_jax.export_autoencoder_kl`` load strictly.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mage_tpu_torch.ops.gn_conv import gn_silu_conv3x3

def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """An ``nn.Conv2d`` on an NHWC tensor."""
    return _nhwc(conv(_nchw(x)))


def _pointwise(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 ``nn.Conv2d`` on an NHWC tensor, as a linear map over C."""
    return F.linear(x, conv.weight.flatten(1), conv.bias)


def _norm(norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    return _nhwc(norm(_nchw(x)))


def _group_norm(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, channels, eps=1e-6)


class DiagonalGaussian:
    """Posterior N(mean, diag(exp(logvar))) over NHWC latents."""

    def __init__(self, moments: torch.Tensor):
        self.mean, logvar = moments.chunk(2, dim=-1)
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)

    def sample(self, noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """mean + std * noise. Without ``noise`` it is drawn from
        ``generator``. Noise is taken in the moments' dtype: f32 noise would
        promote bf16 latents, and the whole stage 2 with them, to f32."""
        if noise is None:
            device = generator.device if generator is not None else self.mean.device
            noise = torch.randn(self.mean.shape, generator=generator, device=device,
                                dtype=self.mean.dtype)
        return self.mean + self.std * noise.to(self.mean.device, self.mean.dtype)

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        """KL(q || N(0, I)) summed over the latent dims, per batch element."""
        return 0.5 * torch.sum(self.mean ** 2 + torch.exp(self.logvar) - 1.0 - self.logvar,
                               dim=tuple(range(1, self.mean.ndim)))


class ResnetBlock(nn.Module):
    """GroupNorm -> silu -> conv3x3, twice, plus a 1x1 shortcut when the
    width changes. ``fused`` (set by ``Decoder`` only) sends both chains
    through ``gn_silu_conv3x3`` in eval mode."""

    def __init__(self, in_ch: int, out_ch: int, dropout: float = 0.0, fused: bool = False):
        super().__init__()
        self.fused = fused
        self.norm1 = _group_norm(in_ch)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = _group_norm(out_ch)
        self.dropout = nn.Dropout(dropout)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.nin_shortcut = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused and not self.training:
            h = x.contiguous()
            for norm, conv in ((self.norm1, self.conv1), (self.norm2, self.conv2)):
                h = gn_silu_conv3x3(h, norm.weight, norm.bias, conv.weight, conv.bias,
                                    groups=norm.num_groups, eps=norm.eps)
        else:
            h = _conv(self.conv1, F.silu(_norm(self.norm1, x)))
            h = _conv(self.conv2, self.dropout(F.silu(_norm(self.norm2, h))))
        if self.nin_shortcut is not None:
            x = _pointwise(self.nin_shortcut, x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over the H*W grid (plain PyTorch: the JAX
    package computes it outside any kernel)."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = _group_norm(channels)
        self.q = nn.Conv2d(channels, channels, 1)
        self.k = nn.Conv2d(channels, channels, 1)
        self.v = nn.Conv2d(channels, channels, 1)
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        hn = _norm(self.norm, x)
        q, k, v = (_pointwise(m, hn).reshape(b, h * w, c) for m in (self.q, self.k, self.v))
        attn = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(c), dim=-1)
        return x + _pointwise(self.proj_out, (attn @ v).reshape(b, h, w, c))


class _Down(nn.Module):
    """Pad bottom and right by one, then a stride-2 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _nhwc(self.conv(F.pad(_nchw(x), (0, 1, 0, 1))))


class _Up(nn.Module):
    """``conv3x3(nearest_up2(x))`` with the weight of one 3x3 ``conv``.

    Nearest upsampling is zero insertion convolved with ones(2, 2), so the
    composition is a 4x4 kernel W'[k] = W[k-1] + W[k] per axis over the
    2x-dilated input: a stride-2 transposed conv (whose kernel is the
    flipped one, laid out (in, out, kh, kw))."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.conv.weight
        k4 = F.pad(w, (0, 0, 1, 0)) + F.pad(w, (0, 0, 0, 1))
        k4 = F.pad(k4, (1, 0)) + F.pad(k4, (0, 1))
        k4 = k4.flip(2, 3).transpose(0, 1).to(x.dtype)
        return _nhwc(F.conv_transpose2d(_nchw(x), k4, self.conv.bias, stride=2, padding=1))


def _level() -> nn.Module:
    level = nn.Module()
    level.block = nn.ModuleList()
    level.attn = nn.ModuleList()
    return level


def _mid(channels: int, dropout: float, fused: bool) -> nn.Module:
    mid = nn.Module()
    mid.block_1 = ResnetBlock(channels, channels, dropout, fused)
    mid.attn_1 = AttnBlock(channels)
    mid.block_2 = ResnetBlock(channels, channels, dropout, fused)
    return mid


class Encoder(nn.Module):
    def __init__(self, ch: int, ch_mult: Sequence[int], num_res_blocks: int,
                 in_channels: int, z_channels: int, double_z: bool = True,
                 attn_resolutions: Sequence[int] = (), resolution: int = 128,
                 dropout: float = 0.0):
        super().__init__()
        self.conv_in = nn.Conv2d(in_channels, ch, 3, padding=1)
        res, block_in = resolution, ch
        self.down = nn.ModuleList()
        for i, mult in enumerate(ch_mult):
            level = _level()
            for _ in range(num_res_blocks):
                level.block.append(ResnetBlock(block_in, ch * mult, dropout))
                block_in = ch * mult
                if res in attn_resolutions:
                    level.attn.append(AttnBlock(block_in))
            if i != len(ch_mult) - 1:
                level.downsample = _Down(block_in)
                res //= 2
            self.down.append(level)
        self.mid = _mid(block_in, dropout, fused=False)
        self.norm_out = _group_norm(block_in)
        self.conv_out = nn.Conv2d(block_in, 2 * z_channels if double_z else z_channels, 3,
                                  padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _conv(self.conv_in, x)
        for level in self.down:
            for j, block in enumerate(level.block):
                h = block(h)
                if len(level.attn):
                    h = level.attn[j](h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        return _conv(self.conv_out, F.silu(_norm(self.norm_out, h)))


class Decoder(nn.Module):
    def __init__(self, ch: int, ch_mult: Sequence[int], num_res_blocks: int, out_ch: int,
                 z_channels: int, attn_resolutions: Sequence[int] = (),
                 resolution: int = 128, dropout: float = 0.0):
        super().__init__()
        block_in = ch * ch_mult[-1]
        self.conv_in = nn.Conv2d(z_channels, block_in, 3, padding=1)
        self.mid = _mid(block_in, dropout, fused=True)
        res = resolution // 2 ** (len(ch_mult) - 1)
        levels = []
        for i in reversed(range(len(ch_mult))):
            level = _level()
            for _ in range(num_res_blocks + 1):
                level.block.append(ResnetBlock(block_in, ch * ch_mult[i], dropout, fused=True))
                block_in = ch * ch_mult[i]
                if res in attn_resolutions:
                    level.attn.append(AttnBlock(block_in))
            if i != 0:
                level.upsample = _Up(block_in)
                res *= 2
            levels.insert(0, level)
        self.up = nn.ModuleList(levels)
        self.norm_out = _group_norm(block_in)
        self.conv_out = nn.Conv2d(block_in, out_ch, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = _conv(self.conv_in, z)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        for i in reversed(range(len(self.up))):
            level = self.up[i]
            for j, block in enumerate(level.block):
                h = block(h)
                if len(level.attn):
                    h = level.attn[j](h)
            if i != 0:
                h = level.upsample(h)
        return _conv(self.conv_out, F.silu(_norm(self.norm_out, h)))


class AutoencoderKL(nn.Module):
    """The ldm KL autoencoder with the JAX package's constructor (the
    ``ddconfig`` fields flattened). ``logvar_bias`` shifts the predicted
    log-variance, as in the JAX package."""

    def __init__(self, embed_dim: int = 4, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, in_channels: int = 3, out_ch: int = 3,
                 z_channels: int = 4, double_z: bool = True,
                 attn_resolutions: Sequence[int] = (), resolution: int = 128,
                 dropout: float = 0.0, logvar_bias: float = 0.0):
        super().__init__()
        self.embed_dim = embed_dim
        self.resolution = resolution
        self.logvar_bias = logvar_bias
        self.encoder = Encoder(ch, ch_mult, num_res_blocks, in_channels, z_channels,
                               double_z, attn_resolutions, resolution, dropout)
        self.decoder = Decoder(ch, ch_mult, num_res_blocks, out_ch, z_channels,
                               attn_resolutions, resolution, dropout)
        zc = 2 * z_channels if double_z else z_channels
        self.quant_conv = nn.Conv2d(zc, zc, 1)
        self.post_quant_conv = nn.Conv2d(zc // 2, z_channels, 1)

    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) frames -> (B, h, w, 2 * z) posterior moments."""
        moments = _pointwise(self.quant_conv, self.encoder(x))
        if self.logvar_bias:
            mean, logvar = moments.chunk(2, dim=-1)
            moments = torch.cat([mean, logvar + self.logvar_bias], dim=-1)
        return moments

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(B, h, w, z) latents -> (B, H, W, C) frames."""
        return self.decoder(_pointwise(self.post_quant_conv, z))

    def forward(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """(B, H, W, C) frames -> (reconstruction, posterior), as the JAX
        ``__call__``: the decode of one posterior sample, whose standard-normal
        ``noise`` (B, h, w, z) is drawn from ``generator`` when not given."""
        posterior = DiagonalGaussian(self.encode_moments(x))
        return self.decode(posterior.sample(noise, generator)), posterior
