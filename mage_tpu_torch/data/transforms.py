"""Clip-level transforms on NumPy video arrays (T, H, W, C).

Host-side equivalents of the subset of utils/videotransforms.py the
reference pipelines actually use (SURVEY.md §2.4): Resize, CenterCrop,
RandomCrop, RandomResizedCrop, horizontal/vertical flips, ClipToTensor
(here ``ToFloat``), Normalize — plus Compose. Everything stays NHWC uint8
until ``ToFloat``; the normalize step can also run on-device inside the
jitted preprocessing path.
"""

from __future__ import annotations

import math
import random
from typing import Optional, Sequence

import numpy as np

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None


def _as_thwc(clip: np.ndarray) -> np.ndarray:
    clip = np.asarray(clip)
    if clip.ndim == 3:  # (T, H, W) grayscale
        clip = clip[..., None]
    if clip.ndim != 4:
        raise ValueError(f"expected (T,H,W,C) clip, got {clip.shape}")
    return clip


def _resize_frame(frame: np.ndarray, size_hw: tuple[int, int]) -> np.ndarray:
    h, w = size_hw
    if cv2 is not None:
        out = cv2.resize(frame, (w, h), interpolation=cv2.INTER_LINEAR)
        if out.ndim == 2:
            out = out[..., None]
        return out
    from PIL import Image

    img = Image.fromarray(frame.squeeze(-1) if frame.shape[-1] == 1 else frame)
    out = np.asarray(img.resize((w, h), Image.BILINEAR))
    if out.ndim == 2:
        out = out[..., None]
    return out


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, clip, rng: Optional[random.Random] = None):
        rng = rng or random
        for t in self.transforms:
            clip = t(clip, rng) if _wants_rng(t) else t(clip)
        return clip


def _wants_rng(t) -> bool:
    return getattr(t, "_stochastic", False)


class Resize:
    """Shorter-side resize when given an int; exact (h, w) when a tuple
    (reference videotransforms Resize/resize_clip:62-110,270-287)."""

    def __init__(self, size):
        self.size = size

    def __call__(self, clip):
        clip = _as_thwc(clip)
        t, h, w, c = clip.shape
        if isinstance(self.size, int):
            if h <= w:
                nh, nw = self.size, max(1, round(w * self.size / h))
            else:
                nh, nw = max(1, round(h * self.size / w)), self.size
        else:
            nh, nw = self.size
        if (nh, nw) == (h, w):
            return clip
        return np.stack([_resize_frame(f, (nh, nw)) for f in clip])


class CenterCrop:
    def __init__(self, size: int):
        self.size = size

    def __call__(self, clip):
        clip = _as_thwc(clip)
        _, h, w, _ = clip.shape
        th = tw = self.size
        i, j = (h - th) // 2, (w - tw) // 2
        return clip[:, i : i + th, j : j + tw]


class RandomCrop:
    _stochastic = True

    def __init__(self, size: int):
        self.size = size

    def __call__(self, clip, rng=random):
        clip = _as_thwc(clip)
        _, h, w, _ = clip.shape
        i = rng.randint(0, h - self.size) if h > self.size else 0
        j = rng.randint(0, w - self.size) if w > self.size else 0
        return clip[:, i : i + self.size, j : j + self.size]


class RandomResizedCrop:
    """Crop a random area/aspect patch then resize — same sampling scheme
    as torchvision's (used at train_vqvae.py:87,99) and the reference's
    clip version (videotransforms.py:334-422)."""

    _stochastic = True

    def __init__(self, size: int, scale=(0.8, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0)):
        self.size = size
        self.scale = scale
        self.ratio = ratio

    def __call__(self, clip, rng=random):
        clip = _as_thwc(clip)
        _, h, w, _ = clip.shape
        area = h * w
        for _ in range(10):
            target_area = rng.uniform(*self.scale) * area
            log_ratio = (math.log(self.ratio[0]), math.log(self.ratio[1]))
            aspect = math.exp(rng.uniform(*log_ratio))
            cw = int(round(math.sqrt(target_area * aspect)))
            ch = int(round(math.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                i = rng.randint(0, h - ch)
                j = rng.randint(0, w - cw)
                patch = clip[:, i : i + ch, j : j + cw]
                return np.stack([_resize_frame(f, (self.size, self.size)) for f in patch])
        # fallback: center crop of the shorter side
        s = min(h, w)
        patch = CenterCrop(s)(clip)
        return np.stack([_resize_frame(f, (self.size, self.size)) for f in patch])


class RandomHorizontalFlip:
    _stochastic = True

    def __call__(self, clip, rng=random):
        return np.ascontiguousarray(clip[:, :, ::-1]) if rng.random() < 0.5 else clip


class RandomVerticalFlip:
    _stochastic = True

    def __call__(self, clip, rng=random):
        return np.ascontiguousarray(clip[:, ::-1]) if rng.random() < 0.5 else clip


class ToFloat:
    """uint8 [0,255] -> float32 [0,1] (the reference's ClipToTensor scale,
    videotransforms.py:631-682 — layout here stays NHWC for TPU)."""

    def __call__(self, clip):
        clip = _as_thwc(clip)
        if clip.dtype == np.uint8:
            return clip.astype(np.float32) / 255.0
        return clip.astype(np.float32)


class Normalize:
    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, clip):
        return (np.asarray(clip, np.float32) - self.mean) / self.std


class RandomRotation:
    """Rotate the whole clip by one random angle in (-degrees, degrees)
    (reference videotransforms.py:425-464)."""

    _stochastic = True

    def __init__(self, degrees: float = 10.0):
        self.degrees = degrees

    def __call__(self, clip, rng=random):
        angle = rng.uniform(-self.degrees, self.degrees)
        clip = _as_thwc(clip)
        if cv2 is not None:
            t, h, w, c = clip.shape
            m = cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1.0)
            out = np.stack([
                cv2.warpAffine(f, m, (w, h)).reshape(h, w, -1) for f in clip
            ])
            return out
        from PIL import Image

        frames = []
        for f in clip:
            img = Image.fromarray(f.squeeze(-1) if f.shape[-1] == 1 else f)
            arr = np.asarray(img.rotate(angle))
            frames.append(arr if arr.ndim == 3 else arr[..., None])
        return np.stack(frames)


class ColorJitter:
    """Brightness/contrast/saturation jitter with one draw per clip
    (reference videotransforms.py:511-591)."""

    _stochastic = True

    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation

    def _factor(self, rng, amount):
        return rng.uniform(max(0.0, 1.0 - amount), 1.0 + amount) if amount else 1.0

    def __call__(self, clip, rng=random):
        clip = _as_thwc(clip).astype(np.float32)
        scale = 255.0 if clip.max() > 1.5 else 1.0
        b = self._factor(rng, self.brightness)
        c = self._factor(rng, self.contrast)
        s = self._factor(rng, self.saturation)
        clip = clip * b
        mean = clip.mean(axis=(1, 2, 3), keepdims=True)
        clip = (clip - mean) * c + mean
        if clip.shape[-1] == 3 and s != 1.0:
            gray = clip.mean(axis=-1, keepdims=True)
            clip = (clip - gray) * s + gray
        return np.clip(clip, 0, scale).astype(np.float32 if scale == 1.0 else np.uint8)


class RandomGrayscale:
    """(reference videotransforms.py:208-237)."""

    _stochastic = True

    def __init__(self, p: float = 0.1):
        self.p = p

    def __call__(self, clip, rng=random):
        clip = _as_thwc(clip)
        if clip.shape[-1] == 3 and rng.random() < self.p:
            weights = np.asarray([0.299, 0.587, 0.114], np.float32)
            gray = (clip.astype(np.float32) @ weights)[..., None]
            clip = np.repeat(gray, 3, axis=-1).astype(clip.dtype)
        return clip


class GaussianBlur:
    """(reference videotransforms.py:694-707)."""

    _stochastic = True

    def __init__(self, sigma_range=(0.1, 2.0), kernel_size: int = 5):
        self.sigma_range = sigma_range
        self.kernel_size = kernel_size

    def __call__(self, clip, rng=random):
        clip = _as_thwc(clip)
        sigma = rng.uniform(*self.sigma_range)
        if cv2 is not None:
            k = self.kernel_size | 1
            out = np.stack([
                cv2.GaussianBlur(f, (k, k), sigma).reshape(f.shape[0], f.shape[1], -1)
                for f in clip
            ])
            return out.astype(clip.dtype)
        from scipy.ndimage import gaussian_filter

        return gaussian_filter(clip, sigma=(0, sigma, sigma, 0)).astype(clip.dtype)


class ColorInversion:
    """Invert intensities (reference ColorConversion,
    videotransforms.py:710-719)."""

    def __call__(self, clip):
        clip = _as_thwc(clip)
        if clip.dtype == np.uint8:
            return 255 - clip
        return 1.0 - clip
