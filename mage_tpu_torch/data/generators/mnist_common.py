"""Shared machinery for the Moving-MNIST dataset generators.

Physics parity with the reference generators (data/mnist_caption_single.py,
data/mnist_caption_double.py, data/mnist_caption_double_modified.py):
64x64 canvas, 28x28 digits, speed 2 at step 0.1, wall reflection in unit
coordinates, trajectories scaled to the 36-pixel canvas range.

Digit source: the reference pulls MNIST via tf.keras
(mnist_caption_single.py:168-174), which needs network access. Here
``load_digit_bank`` reads a local ``.npz`` (images uint8 (N,28,28), labels
(N,)) when given, and otherwise renders a procedural bank with PIL's
built-in font + random jitter — same shapes/contrast, no download.
"""

from __future__ import annotations

import numpy as np

IMAGE_SIZE = 64
DIGIT_SIZE = 28
STEP_LENGTH = 0.1
CANVAS = IMAGE_SIZE - DIGIT_SIZE  # 36


def load_digit_bank(
    mnist_npz: str | None = None, samples_per_digit: int = 100, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """-> (images uint8 (N,28,28), labels int (N,))."""
    if mnist_npz:
        with np.load(mnist_npz) as z:
            if "images" in z:
                return z["images"].astype(np.uint8), z["labels"].astype(np.int64)
            # keras mnist.npz layout
            imgs = np.concatenate([z["x_train"], z["x_test"]])
            labels = np.concatenate([z["y_train"], z["y_test"]])
            return imgs.astype(np.uint8), labels.astype(np.int64)
    return _procedural_digits(samples_per_digit, seed)


def _procedural_digits(samples_per_digit: int, seed: int):
    from PIL import Image, ImageDraw, ImageFont

    rng = np.random.RandomState(seed)
    font = ImageFont.load_default()
    images, labels = [], []
    for digit in range(10):
        # render once big, then jitter per sample
        img = Image.new("L", (24, 24), 0)
        d = ImageDraw.Draw(img)
        d.text((6, 4), str(digit), fill=255, font=font)
        base = img.resize((22, 22), Image.BILINEAR)
        for _ in range(samples_per_digit):
            canvas = Image.new("L", (DIGIT_SIZE, DIGIT_SIZE), 0)
            dx, dy = rng.randint(0, 7), rng.randint(0, 7)
            canvas.paste(base, (dx, dy))
            if rng.rand() < 0.5:
                canvas = canvas.rotate(float(rng.uniform(-12, 12)), resample=Image.BILINEAR)
            arr = np.asarray(canvas, np.float32) * float(rng.uniform(0.85, 1.0))
            images.append(arr.astype(np.uint8))
            labels.append(digit)
    return np.stack(images), np.asarray(labels, np.int64)


def bounce_trajectory(
    length: int,
    rng: np.random.RandomState,
    motion: int,
    direction: int,
    start: tuple[float, float] | None = None,
    stop_at_wall: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Unit-square bounce walk -> integer (y, x) pixel tracks of ``length``.

    ``motion``: 0 = vertical (theta=pi/2), 1 = horizontal (theta=0)
    (reference mnist_caption_single.py:72-75). ``direction``: 1 = +v
    (down/right), 0 = -v (up/left) (:80-87). ``stop_at_wall`` freezes at the
    first wall hit instead of reflecting (the modified-double variant,
    data/mnist_caption_double_modified.py:74-139).
    """
    y = rng.rand() if start is None else start[0]
    x = rng.rand() if start is None else start[1]
    theta = 0.5 * np.pi if motion == 0 else 0.0
    v_y, v_x = 2 * np.sin(theta), 2 * np.cos(theta)
    if direction == 0:
        v_y, v_x = -v_y, -v_x
    ys, xs = np.zeros(length), np.zeros(length)
    stopped = False
    for i in range(length):
        if not stopped:
            y += v_y * STEP_LENGTH
            x += v_x * STEP_LENGTH
            if x <= 0.0:
                x = 0.0
                if stop_at_wall:
                    stopped = True
                v_x = -v_x
            elif x >= 1.0:
                x = 1.0
                if stop_at_wall:
                    stopped = True
                v_x = -v_x
            if y <= 0.0:
                y = 0.0
                if stop_at_wall:
                    stopped = True
                v_y = -v_y
            elif y >= 1.0:
                y = 1.0
                if stop_at_wall:
                    stopped = True
                v_y = -v_y
        ys[i], xs[i] = y, x
    return (CANVAS * ys).astype(np.int32), (CANVAS * xs).astype(np.int32)


def render_video(
    digit_images: list[np.ndarray],
    tracks: list[tuple[np.ndarray, np.ndarray]],
    length: int,
    static_overlays: list[tuple[np.ndarray, int, int]] | None = None,
) -> np.ndarray:
    """Composite digits along tracks; overlap = max
    (reference mnist_caption_single.py:111-128). -> uint8 (T, 64, 64)."""
    video = np.zeros((length, IMAGE_SIZE, IMAGE_SIZE), np.float32)
    for t in range(length):
        frame = video[t]
        for img, (ys, xs) in zip(digit_images, tracks):
            top, left = int(ys[t]), int(xs[t])
            region = frame[top : top + DIGIT_SIZE, left : left + DIGIT_SIZE]
            np.maximum(region, img, out=region)
        if static_overlays:
            for img, top, left in static_overlays:
                region = frame[top : top + DIGIT_SIZE, left : left + DIGIT_SIZE]
                np.maximum(region, img, out=region)
    return video.astype(np.uint8)


def digit_motion_split(rng: np.random.RandomState):
    """Disjoint (digit, motion) train/val assignment: each digit trains on
    one motion axis and validates on the other
    (reference mnist_caption_single.py:32-45). Returns two arrays of codes
    ``digit + 10*motion``."""
    numbers = rng.permutation(10)
    train, val = [], []
    for i in range(10):
        if i % 2 == 0:
            val.append(numbers[i])  # motion 0
            train.append(10 + numbers[i])  # motion 1
        else:
            val.append(10 + numbers[i])
            train.append(numbers[i])
    return np.asarray(train), np.asarray(val)


MOTION_STRINGS = ["up then down", "left then right", "down then up", "right then left"]
