"""Stage-1 frame autoencoder: the VQ-VAE, f4 (MNIST, 64 -> 16) and f8
(CATER, 128 -> 16).

Port of ``mage_tpu/models/vqvae.py``. ``down_ratio=4``: two stride-2 4x4
convs (BatchNorm between) and two ``ResBlock``s, mirrored by a decoder of two
``ResBlock``s and two stride-2 4x4 transposed convs, then Tanh; codebook
width ``dim``. ``down_ratio=8``: a 7x7 stem, four bottleneck
``EncoderBlock``s with three 2x max-pools, codebook width ``4 * dim``, and a
decoder of four ``DecoderBlock``s whose 2x nearest upsample is commuted past
the block's pointwise entry (relu and the two 1x1 convs), as in the JAX
package. Public tensors are NHWC; convolutions run on NCHW views of them.

``encode`` (one ids-only vq launch) and ``decode`` are the frozen first
stage's calls. ``forward`` is the training forward, ``(x_tilde, z_e,
z_q_bar)``: the decoder runs on the straight-through codes of a detached
codebook, and ``z_q_bar`` re-selects the codes from the attached codebook so
that the quantization loss trains it.

BatchNorm (f4 only) is flax's: momentum 0.9 (torch's 0.1) and running
variances updated with the biased batch variance. ``batch_statistics_only``
runs train mode's batch statistics without touching the running averages,
as the JAX trainer's eval step, reconstruction and codebook restart do.

Parameter names are the reference state-dict keys (f8: ``encoder.{0,1,3,5,7}``,
``decoder.{0,2,4,6,8}``; f4: ``encoder.{0,1,3,4,5}``, ``decoder.{0,1,3,4,6}``;
``codebook.embedding``), so ``compat.from_jax`` output, the reference ``.pt``
files and the port's trainer checkpoints load strictly.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from mage_tpu_torch.ops.vq import (
    codebook_lookup,
    nearest_codebook_indices,
    vq_straight_through,
)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _upsample_nearest(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


class BatchNorm2d(nn.BatchNorm2d):
    """flax's ``nn.BatchNorm(momentum=0.9)`` under ``nn.BatchNorm2d``'s keys
    (eps 1e-5, NCHW). Train mode normalises by the batch statistics and, when
    ``update_stats``, moves the running averages 0.1 of the way to them,
    the variance being the biased one (torch's own update takes the unbiased
    one, which would be n/(n-1) off flax's). Eval mode normalises by the
    running averages."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.1)
        self.update_stats = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.update_stats:
            with torch.no_grad():
                var, mean = torch.var_mean(x.to(torch.promote_types(x.dtype, torch.float32)),
                                           dim=(0, 2, 3), unbiased=False)
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
                self.running_var.mul_(1.0 - m).add_(var, alpha=m)
                self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


@contextlib.contextmanager
def batch_statistics_only(model: nn.Module):
    """Within the block, train-mode BatchNorm normalises by the batch
    statistics but leaves the running averages as they are: the JAX trainer's
    eval step, reconstruction and restart run ``train=True`` and drop the
    mutated ``batch_stats``."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m in norms:
            m.update_stats = True


class ResBlock(nn.Module):
    """relu, 3x3 conv, BN, relu, 1x1 conv, BN, added to ``relu(x)``: the
    reference's ``block`` starts with an in-place ReLU, which also changes the
    tensor its residual adds. NCHW."""

    def __init__(self, dim: int):
        super().__init__()
        self.block = nn.Sequential(
            nn.ReLU(), nn.Conv2d(dim, dim, 3, padding=1), BatchNorm2d(dim),
            nn.ReLU(), nn.Conv2d(dim, dim, 1), BatchNorm2d(dim),
        )

    def forward(self, x):
        xr = F.relu(x)
        return xr + self.block[1:](xr)


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
    """``encode`` (B, H, W, C) -> (B, h, w) ids, ``decode`` back, and the
    training ``forward``; ``down_ratio`` 4 or 8 picks the architecture."""

    def __init__(self, input_dim: int = 3, down_ratio: int = 8, dim: int = 256,
                 K: int = 512):
        super().__init__()
        self.dim = dim
        self.down_ratio = down_ratio
        if down_ratio == 4:
            self.encoder = nn.Sequential(
                nn.Conv2d(input_dim, dim, 4, stride=2, padding=1), BatchNorm2d(dim), nn.ReLU(),
                nn.Conv2d(dim, dim, 4, stride=2, padding=1), ResBlock(dim), ResBlock(dim),
            )
            self.decoder = nn.Sequential(
                ResBlock(dim), ResBlock(dim), nn.ReLU(),
                nn.ConvTranspose2d(dim, dim, 4, stride=2, padding=1), BatchNorm2d(dim),
                nn.ReLU(), nn.ConvTranspose2d(dim, input_dim, 4, stride=2, padding=1),
                nn.Tanh(),
            )
        elif down_ratio == 8:
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
        else:
            raise ValueError(f"unsupported down_ratio {down_ratio}")
        self.codebook = _Codebook(K, self.embed_dim)

    @property
    def embed_dim(self) -> int:
        return self.dim if self.down_ratio == 4 else 4 * self.dim

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) frames -> (B, h, w) int32 codebook ids."""
        z_e = _nhwc(self.encoder(_nchw(x)))
        return nearest_codebook_indices(z_e, self.codebook.embedding.weight)

    def decode(self, ids: torch.Tensor) -> torch.Tensor:
        """(B, h, w) ids -> (B, H, W, C) frames in [-1, 1]."""
        z_q = codebook_lookup(self.codebook.embedding.weight, ids)
        return _nhwc(self.decoder(_nchw(z_q)))

    def forward(self, x: torch.Tensor):
        """(B, H, W, C) frames -> ``(x_tilde, z_e, z_q_bar)``, NHWC: the
        decode of the straight-through codes (no gradient reaches the
        codebook through them, as the reference passes ``codebook.detach()``),
        the encoder's output, and the same codes gathered from the attached
        codebook."""
        z_e = _nhwc(self.encoder(_nchw(x)))
        codebook = self.codebook.embedding.weight
        codes, ids = vq_straight_through(z_e, codebook.detach())
        x_tilde = _nhwc(self.decoder(_nchw(codes)))
        return x_tilde, z_e, codebook_lookup(codebook, ids)
