"""I3D (Inflated Inception-V1), the FVD feature network, as torch modules.

Port of ``mage_tpu/evals/i3d.py``. The modules and their parameters carry
piergiaj/pytorch-i3d's own names (``Conv3d_1a_7x7.conv3d.weight``,
``Mixed_3b.b1a.bn.running_mean``, ``logits.conv3d.bias``), so a user's
Kinetics checkpoint (``rgb_imagenet.pt``) loads strictly with no importer:

    from mage_tpu_torch.evals.i3d import make_extractor
    extract = make_extractor(torch.load("rgb_imagenet.pt"))

Numerics are the JAX package's: TensorFlow "SAME" padding for every conv and
max-pool (asymmetric, the extra row at the end), max-pool padding with
-inf, BatchNorm eps 1e-3 on its running statistics. Videos are NTHWC at the
module boundary, (N, T, H, W, 3) in [-1, 1], and the layers run NCTHW
inside.

With random weights the deep stack mean-field-collapses (every video maps to
nearly the same logits), so a random-init extractor must stop at the shallow
``Mixed_3c`` endpoint, where random projections still discriminate
(``mage_tpu/evals/i3d.py``'s I3D docstring has the measurement).
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

ENDPOINTS = ("logits", "Mixed_3c", "Mixed_4f")
# (b0, b1a, b1b, b2a, b2b, b3b) output channels, pytorch-i3d's order
INCEPTIONS = {
    "Mixed_3b": (64, 96, 128, 16, 32, 32),
    "Mixed_3c": (128, 128, 192, 32, 96, 64),
    "Mixed_4b": (192, 96, 208, 16, 48, 64),
    "Mixed_4c": (160, 112, 224, 24, 64, 64),
    "Mixed_4d": (128, 128, 256, 24, 64, 64),
    "Mixed_4e": (112, 144, 288, 32, 64, 64),
    "Mixed_4f": (256, 160, 320, 32, 128, 128),
    "Mixed_5b": (256, 160, 320, 32, 128, 128),
    "Mixed_5c": (384, 192, 384, 48, 128, 128),
}
FEATURE_DIMS = {"Mixed_3c": 480, "Mixed_4f": 832}


def _same_pads(size_thw, window, stride) -> list:
    """TensorFlow SAME padding of an NCTHW tensor as ``F.pad`` takes it
    (last dim first): out = ceil(size / stride), the total padding
    (out - 1) * stride + window - size, its extra element at the end."""
    pads = []
    for size, w, s in zip(size_thw, window, stride):
        out = -(-size // s)
        pad = max((out - 1) * s + w - size, 0)
        pads.append((pad // 2, pad - pad // 2))
    return [p for lo_hi in reversed(pads) for p in lo_hi]


def max_pool_same(x: torch.Tensor, window, stride) -> torch.Tensor:
    """Max-pool with SAME padding filled with -inf (flax's ``max_pool``)."""
    x = F.pad(x, _same_pads(x.shape[2:], window, stride), value=-math.inf)
    return F.max_pool3d(x, window, stride)


class Unit3D(nn.Module):
    """Conv3d (SAME padding, no bias unless ``use_bias``) + BatchNorm3d
    (eps 1e-3, running statistics) + ReLU, keyed ``conv3d`` and ``bn``."""

    def __init__(self, in_channels: int, out_channels: int, kernel=(1, 1, 1),
                 stride=(1, 1, 1), use_bn: bool = True, activation: bool = True,
                 use_bias: bool = False):
        super().__init__()
        self.kernel, self.stride = tuple(kernel), tuple(stride)
        self.activation = activation
        self.conv3d = nn.Conv3d(in_channels, out_channels, self.kernel, self.stride,
                                bias=use_bias)
        # momentum as pytorch-i3d's; it acts only in train mode
        self.bn = nn.BatchNorm3d(out_channels, eps=1e-3, momentum=0.01) if use_bn else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv3d(F.pad(x, _same_pads(x.shape[2:], self.kernel, self.stride)))
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.activation else x


class InceptionModule(nn.Module):
    """Four branches (1x1 / 1x1-3x3 / 1x1-3x3 / pool-1x1), concatenated."""

    def __init__(self, in_channels: int, out: tuple):
        super().__init__()
        self.b0 = Unit3D(in_channels, out[0])
        self.b1a = Unit3D(in_channels, out[1])
        self.b1b = Unit3D(out[1], out[2], (3, 3, 3))
        self.b2a = Unit3D(in_channels, out[3])
        self.b2b = Unit3D(out[3], out[4], (3, 3, 3))
        self.b3b = Unit3D(in_channels, out[5])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.b3b(max_pool_same(x, (3, 3, 3), (1, 1, 1)))
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)), b3],
                         dim=1)


class I3D(nn.Module):
    """Inflated Inception-V1 with a ``num_classes`` head. ``forward`` takes
    (N, T, H, W, 3) and returns the logits (pre-softmax), or with another
    ``endpoint`` the features of that stage averaged over T, H and W. Every
    layer exists whatever the endpoint, so a full checkpoint loads
    strictly."""

    def __init__(self, num_classes: int = 400, endpoint: str = "logits"):
        super().__init__()
        if endpoint not in ENDPOINTS:
            # an unknown endpoint must not fall through to the logits, the
            # feature that collapses on random weights
            raise ValueError(f"unknown I3D endpoint {endpoint!r}; expected one of {ENDPOINTS}")
        self.endpoint = endpoint
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(64, 64)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3))
        cin = 192
        for name, out in INCEPTIONS.items():
            self.add_module(name, InceptionModule(cin, out))
            cin = out[0] + out[2] + out[4] + out[5]
        self.logits = Unit3D(cin, num_classes, use_bn=False, activation=False,
                             use_bias=True)

    def forward(self, videos: torch.Tensor) -> torch.Tensor:
        x = videos.permute(0, 4, 1, 2, 3)  # NTHWC -> NCTHW
        x = self.Conv3d_1a_7x7(x)
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Mixed_3c(self.Mixed_3b(x))
        if self.endpoint == "Mixed_3c":
            return x.mean(dim=(2, 3, 4))
        x = max_pool_same(x, (3, 3, 3), (2, 2, 2))
        for name in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f"):
            x = getattr(self, name)(x)
        if self.endpoint == "Mixed_4f":
            return x.mean(dim=(2, 3, 4))
        x = max_pool_same(x, (2, 2, 2), (2, 2, 2))
        x = self.Mixed_5c(self.Mixed_5b(x))
        x = self.logits(x.mean(dim=(2, 3, 4), keepdim=True))
        return x[:, :, 0, 0, 0]


def random_state_dict(seed: int = 42, num_classes: int = 400) -> dict:
    """pytorch-i3d-keyed random weights drawn from a ``torch.Generator``
    seeded ``seed``: conv weights normal with variance 1/fan_in (flax's
    default scale, untruncated), the logits bias 0, BatchNorm at scale 1,
    shift 0, running mean 0 and variance 1."""
    gen = torch.Generator().manual_seed(seed)
    sd = I3D(num_classes).state_dict()
    for key, value in sd.items():
        if key.endswith("conv3d.weight"):
            fan_in = math.prod(value.shape[1:])
            sd[key] = torch.randn(value.shape, generator=gen) / math.sqrt(fan_in)
        elif key.endswith("conv3d.bias"):
            sd[key] = torch.zeros_like(value)
    return sd


def make_extractor(state_dict: Mapping[str, Any], batch_size: int = 8,
                   endpoint: str = "logits", device=None):
    """-> ``extract(videos)``: (N, T, H, W, 3) uint8 in [0, 255] or float in
    [-1, 1] -> (N, D) f32 numpy features, in ``batch_size`` chunks, from an
    I3D strictly loaded with ``state_dict`` (pytorch-i3d keys; tensors or
    numpy arrays) on ``device`` (the card unless the caller asks for the
    CPU). The canonical feature fn for ``fvd.compute_fvd``; random weights
    want ``endpoint="Mixed_3c"``."""
    from mage_tpu_torch.models.pipeline import resolve_device

    dev = resolve_device(device)
    model = I3D(num_classes=len(state_dict["logits.conv3d.bias"]), endpoint=endpoint)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()}, strict=True)
    model.to(dev).eval()

    @torch.no_grad()
    def extract(videos: np.ndarray) -> np.ndarray:
        x = np.asarray(videos)
        if x.dtype == np.uint8:
            x = x.astype(np.float32) / 127.5 - 1.0
        outs = [model(torch.as_tensor(x[i:i + batch_size], dtype=torch.float32,
                                      device=dev)).float().cpu().numpy()
                for i in range(0, len(x), batch_size)]
        return np.concatenate(outs, axis=0)

    return extract


def random_extractor(batch_size: int = 8, seed: int = 42, device: Optional[Any] = None):
    """The random-init fallback: ``random_state_dict(seed)`` at the
    ``Mixed_3c`` endpoint (480-d features)."""
    return make_extractor(random_state_dict(seed), batch_size, "Mixed_3c", device)
