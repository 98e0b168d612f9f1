"""Stage-1 frame autoencoder: the f8 VQ-VAE (CATER, 128 -> 16).

Port of ``mage_tpu/models/vqvae.py`` for ``down_ratio=8``: a 7x7 stem, four
bottleneck ``EncoderBlock``s with three 2x max-pools, codebook width
``4 * dim``, and a decoder of four ``DecoderBlock``s whose 2x nearest
upsample is commuted past the block's pointwise entry (relu and the two 1x1
convs), as in the JAX package. Public tensors are NHWC; convolutions run on
NCHW views of them.

Parameter names are the reference state-dict keys
(``encoder.{0,1,3,5,7}``, ``decoder.{0,2,4,6,8}``, ``codebook.embedding``),
so ``compat.from_jax`` output and the reference ``.pt`` files load strictly.
The f4 variant (with BatchNorm) and the training forward come later.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mage_tpu_torch.ops.vq import codebook_lookup, nearest_codebook_indices


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _upsample_nearest(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


class EncoderBlock(nn.Module):
    """Bottleneck residual (hid = out/4): relu, 3x (3x3 conv, relu), 1x1
    conv, plus a 1x1 id path when the channel count changes. NCHW."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        hid = dim_out // 4
        self.id_path = nn.Conv2d(dim_in, dim_out, 1) if dim_in != dim_out else None
        self.block = nn.Sequential(
            nn.ReLU(), nn.Conv2d(dim_in, hid, 3, padding=1),
            nn.ReLU(), nn.Conv2d(hid, hid, 3, padding=1),
            nn.ReLU(), nn.Conv2d(hid, hid, 3, padding=1),
            nn.ReLU(), nn.Conv2d(hid, dim_out, 1),
        )

    def forward(self, x):
        idp = x if self.id_path is None else self.id_path(x)
        return idp + self.block(x)


class DecoderBlock(nn.Module):
    """Bottleneck residual: relu, 1x1 conv, then (relu, 3x3 conv) x3, plus a
    1x1 id path when the channel count changes. ``upsample`` applies the 2x
    nearest upsample after the pointwise entry and id path, which is exact
    and costs a quarter of upsampling first. NCHW."""

    def __init__(self, dim_in: int, dim_out: int, upsample: bool = False):
        super().__init__()
        hid = dim_out // 4
        self.upsample = upsample
        self.id_path = nn.Conv2d(dim_in, dim_out, 1) if dim_in != dim_out else None
        self.block = nn.Sequential(
            nn.ReLU(), nn.Conv2d(dim_in, hid, 1),
            nn.ReLU(), nn.Conv2d(hid, hid, 3, padding=1),
            nn.ReLU(), nn.Conv2d(hid, hid, 3, padding=1),
            nn.ReLU(), nn.Conv2d(hid, dim_out, 3, padding=1),
        )

    def forward(self, x):
        idp = x if self.id_path is None else self.id_path(x)
        h = self.block[1](self.block[0](x))
        if self.upsample:
            h = _upsample_nearest(h)
            idp = _upsample_nearest(idp)
        return idp + self.block[2:](h)


class _Codebook(nn.Module):
    def __init__(self, k: int, dim: int):
        super().__init__()
        self.embedding = nn.Embedding(k, dim)


class VectorQuantizedVAE(nn.Module):
    """f8 VQ-VAE: ``encode`` (B, H, W, C) -> (B, h, w) ids, ``decode`` back."""

    def __init__(self, input_dim: int = 3, down_ratio: int = 8, dim: int = 256,
                 K: int = 512):
        super().__init__()
        if down_ratio != 8:
            raise NotImplementedError(
                f"down_ratio={down_ratio}: the port has the f8 VQ-VAE only; the f4 "
                "variant is ROADMAP item A2")
        self.dim = dim
        self.encoder = nn.Sequential(
            nn.Conv2d(input_dim, dim, 7, padding=3),
            EncoderBlock(dim, dim), nn.MaxPool2d(2),
            EncoderBlock(dim, dim), nn.MaxPool2d(2),
            EncoderBlock(dim, 2 * dim), nn.MaxPool2d(2),
            EncoderBlock(2 * dim, 4 * dim), nn.ReLU(),
        )
        # indices 1, 3, 5 hold the upsample in the reference's Sequential;
        # here it lives inside the following DecoderBlock (exact reordering)
        self.decoder = nn.Sequential(
            DecoderBlock(4 * dim, 2 * dim), nn.Identity(),
            DecoderBlock(2 * dim, dim, upsample=True), nn.Identity(),
            DecoderBlock(dim, dim, upsample=True), nn.Identity(),
            DecoderBlock(dim, dim, upsample=True), nn.ReLU(),
            nn.Conv2d(dim, input_dim, 1), nn.Tanh(),
        )
        self.codebook = _Codebook(K, self.embed_dim)

    @property
    def embed_dim(self) -> int:
        return 4 * self.dim

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) frames -> (B, h, w) int32 codebook ids."""
        z_e = _nhwc(self.encoder(_nchw(x)))
        return nearest_codebook_indices(z_e, self.codebook.embedding.weight)

    def decode(self, ids: torch.Tensor) -> torch.Tensor:
        """(B, h, w) ids -> (B, H, W, C) frames in [-1, 1]."""
        z_q = codebook_lookup(self.codebook.embedding.weight, ids)
        return _nhwc(self.decoder(_nchw(z_q)))
