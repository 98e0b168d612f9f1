"""Video file reading via OpenCV (replaces the reference's decord
dependency, dataload.py:8,358-364)."""

from __future__ import annotations

import numpy as np


class VideoReader:
    """Decode-on-demand reader for .avi/.mp4 files. ``get_batch(indices)``
    returns (N, H, W, 3) RGB uint8 like decord's."""

    def __init__(self, path: str):
        import cv2

        self.path = path
        self._cap = cv2.VideoCapture(path)
        if not self._cap.isOpened():
            raise IOError(f"cannot open video {path}")
        self._n = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))

    def __len__(self) -> int:
        return self._n

    def get_batch(self, indices) -> np.ndarray:
        import cv2

        want = sorted(set(int(i) for i in indices))
        frames: dict[int, np.ndarray] = {}
        # sequential scan: cheap for short clips, avoids unreliable seeks in
        # some AVI containers
        self._cap.set(cv2.CAP_PROP_POS_FRAMES, 0)
        pos = 0
        remaining = set(want)
        while remaining:
            ok, frame = self._cap.read()
            if not ok:
                break
            if pos in remaining:
                frames[pos] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                remaining.discard(pos)
            pos += 1
        if remaining:
            last = frames[max(frames)] if frames else None
            if last is None:
                raise IOError(f"no decodable frames in {self.path}")
            for i in remaining:
                frames[i] = last
        return np.stack([frames[int(i)] for i in indices])

    def release(self) -> None:
        self._cap.release()
