"""GIF / video export helpers.

Capability parity with the reference's gif writer (main_mage.py:250-257):
denormalize from [-1, 1] to uint8 and write an animated GIF.
"""

from __future__ import annotations

import os

import numpy as np


def to_uint8_video(video: np.ndarray) -> np.ndarray:
    """(T, H, W, C) or (T, C, H, W) float in [-1, 1] -> (T, H, W, C) uint8."""
    video = np.asarray(video, dtype=np.float32)
    if video.ndim != 4:
        raise ValueError(f"expected 4D video, got {video.shape}")
    if video.shape[1] in (1, 3) and video.shape[-1] not in (1, 3):
        video = video.transpose(0, 2, 3, 1)
    video = (np.clip(video, -1.0, 1.0) + 1.0) * 0.5
    return (video * 255.0).astype(np.uint8)


def save_gif(video: np.ndarray, path: str, fps: int = 3) -> None:
    frames = to_uint8_video(video)
    if frames.shape[-1] == 1:
        frames = np.repeat(frames, 3, axis=-1)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    try:
        import imageio

        imageio.mimsave(path, list(frames), fps=fps)
    except Exception:
        from PIL import Image

        imgs = [Image.fromarray(f) for f in frames]
        imgs[0].save(
            path, save_all=True, append_images=imgs[1:], duration=int(1000 / fps), loop=0
        )
