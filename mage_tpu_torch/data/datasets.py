"""Datasets: Moving MNIST and CATER-GEN, stage-1 (per-frame) and stage-2
(video+caption+speed) variants.

Behavior parity with reference dataload.py:

- ``MovingMnist`` (:183-271): record store of (video, caption); inline
  30-token vocab; speed-conditioned temporal subsampling (speed ~ U(0,1) ->
  frame interval in ``sample_speed`` range, min 1.0); pad-to-length by
  repeating the last frame.
- ``CATER`` (:274-380): JSON annotations ``{split}_{explicit|ambiguous}``
  picked by the ``randomness`` flag; v1/v2 vocabs; video decode + the same
  subsampling with min interval 3.0; returns ``video_id``.
- ``MovingMnist4VQVAE`` (:467-490): one random frame per clip.
- ``CATER4VQVAE`` (:384-400): pre-flattened per-image store
  ``vqvae_{split}``.

TPU-native divergences (documented, not accidental):

- arrays are NHWC / THWC;
- captions are padded to a *fixed* ``context_length`` so stage-2 batches
  have static shapes under jit (the reference pads to the per-batch max,
  dataload.py:262-271 — same semantics, padding is masked in attention).
"""

from __future__ import annotations

import json
import os
import random
import numpy as np

from mage_tpu_torch.data.readers import open_blob_store
from mage_tpu_torch.data.tokenizers import (
    CATERV1_VOCAB,
    CATERV2_VOCAB,
    MNIST_VOCAB,
    VocabTokenizer,
)
from mage_tpu_torch.data import transforms as T


def speed_subsample_indices(
    frame_num: int,
    sample_speed: list[float],
    speed: float,
    min_interval: float,
) -> np.ndarray:
    """speed in [0,1) -> frame indices (reference dataload.py:246-249,
    361-364)."""
    lo, hi = sample_speed[0], sample_speed[-1]
    interval = max(min_interval, speed * (hi - lo) + lo)
    count = int(round(frame_num / interval))
    return np.floor(np.linspace(0, frame_num - 1, max(count, 1), endpoint=True)).astype(
        np.int32
    )


def _encode_padded(tokenizer, caption: str, context_length: int) -> np.ndarray:
    if hasattr(tokenizer, "encode_padded"):
        return tokenizer.encode_padded(caption, context_length)
    ids = np.asarray(tokenizer.encode(caption), np.int32)[:context_length]
    out = np.full((context_length,), tokenizer.padding_idx, np.int32)
    out[: len(ids)] = ids
    return out


def _pad_clip(images: np.ndarray, frames_length: int) -> np.ndarray:
    if images.shape[0] < frames_length:
        pad = np.repeat(images[-1:], frames_length - images.shape[0], axis=0)
        images = np.concatenate([images, pad], axis=0)
    return images


def _video_to_thwc(video: np.ndarray) -> np.ndarray:
    """Accept (T,H,W), (T,1,H,W) or (T,H,W,C); return (T,H,W,C)."""
    video = np.asarray(video)
    if video.ndim == 3:
        return video[..., None]
    if video.ndim == 4 and video.shape[1] in (1, 3) and video.shape[-1] not in (1, 3):
        return video.transpose(0, 2, 3, 1)
    return video


class MovingMnist:
    """Stage-2 dataset: ``{'images': (L,H,W,1) f32, 'text': (ctx,) i32,
    'speed': f32}``."""

    def __init__(
        self,
        data_root: str,
        split: str,
        frames_length: int,
        sample_speed: list,
        context_length: int = 32,
        image_transform=None,
        bert_path=None,
        seed: int = 0,
    ):
        self.reader = open_blob_store(data_root + split)
        self.transform = image_transform
        self.frames_length = frames_length
        self.sample_speed = list(sample_speed)
        self.context_length = context_length
        if bert_path:  # optional pretrained tokenizer (reference dataload.py:205-210)
            from mage_tpu_torch.data.tokenizers import HFTokenizer

            self.tokenizer = HFTokenizer(bert_path)
        else:
            self.tokenizer = VocabTokenizer(MNIST_VOCAB, split_mode="whitespace")
        self.padding_idx = self.tokenizer.padding_idx
        self._rng = random.Random(seed)

    def __len__(self):
        return len(self.reader)

    def encode(self, caption: str) -> np.ndarray:
        return _encode_padded(self.tokenizer, caption, self.context_length)

    def decode(self, tokens) -> str:
        return self.tokenizer.decode(tokens)

    def __getitem__(self, idx: int) -> dict:
        video, caption = self.reader[idx]
        video = _video_to_thwc(video)
        speed = self._rng.random()
        choice = speed_subsample_indices(video.shape[0], self.sample_speed, speed, 1.0)
        clip = video[choice][: self.frames_length]
        if self.transform is not None:
            clip = self.transform(clip, self._rng)
        else:
            clip = clip.astype(np.float32) / 255.0 - 0.5
        clip = _pad_clip(clip.astype(np.float32), self.frames_length)
        return {
            "images": clip,
            "text": self.encode(caption),
            "speed": np.float32(speed),
        }


class MovingMnist4VQVAE:
    """Stage-1: one random frame per clip (reference dataload.py:467-490)."""

    def __init__(self, data_root: str, split: str, image_transform=None, seed: int = 0):
        self.reader = open_blob_store(data_root + split)
        self.transform = image_transform
        self._rng = random.Random(seed)

    def __len__(self):
        return len(self.reader)

    def __getitem__(self, idx: int) -> np.ndarray:
        video, _ = self.reader[idx]
        video = _video_to_thwc(video)
        frame = video[self._rng.randrange(video.shape[0])]
        if self.transform is not None:
            return self.transform(frame[None], self._rng)[0].astype(np.float32)
        return frame.astype(np.float32) / 255.0 - 0.5


class CATER:
    """Stage-2 CATER-GEN dataset (reference dataload.py:274-380)."""

    def __init__(
        self,
        dataset: str,
        data_root: str,
        split: str,
        frames_length: int,
        sample_speed: list,
        context_length: int = 38,
        image_transform="default",
        tokenizer_path=None,
        randomness: bool = False,
        seed: int = 0,
    ):
        mode = "ambiguous" if randomness else "explicit"
        with open(os.path.join(data_root, f"{split}_{mode}.json")) as fp:
            self.anno = json.load(fp)
        self.data_root = data_root
        self.frames_length = frames_length
        self.sample_speed = list(sample_speed)
        self.context_length = context_length
        if image_transform == "default":
            image_transform = T.Compose(
                [T.Resize(128), T.ToFloat(), T.Normalize([0.5], [0.5])]
            )
        self.transform = image_transform
        if tokenizer_path:  # (reference dataload.py:314-319)
            from mage_tpu_torch.data.tokenizers import HFTokenizer

            self.tokenizer = HFTokenizer(tokenizer_path)
        else:
            vocab = CATERV1_VOCAB if dataset == "caterv1" else CATERV2_VOCAB
            self.tokenizer = VocabTokenizer(vocab, split_mode="regex")
        self.padding_idx = self.tokenizer.padding_idx
        self._rng = random.Random(seed)

    def __len__(self):
        return len(self.anno)

    def encode(self, caption: str) -> np.ndarray:
        return _encode_padded(self.tokenizer, caption, self.context_length)

    def decode(self, tokens) -> str:
        return self.tokenizer.decode(tokens)

    def __getitem__(self, idx: int) -> dict:
        from mage_tpu_torch.data.video import VideoReader

        rec = self.anno[str(idx)]
        path = os.path.join(self.data_root, rec["video"])
        vid = VideoReader(path)
        speed = self._rng.random()
        choice = speed_subsample_indices(len(vid), self.sample_speed, speed, 3.0)
        images = vid.get_batch(choice)[: self.frames_length]
        vid.release()
        if self.transform is not None:
            images = self.transform(images, self._rng)
        images = _pad_clip(images.astype(np.float32), self.frames_length)
        return {
            "video_id": os.path.basename(path),
            "images": images,
            "text": self.encode(rec["caption"]),
            "speed": np.float32(speed),
        }


class CATER4VQVAE:
    """Stage-1: per-image store ``vqvae_{split}`` (dataload.py:384-400)."""

    def __init__(self, data_root: str, split: str, image_transform=None, seed: int = 0):
        self.reader = open_blob_store(os.path.join(data_root, f"vqvae_{split}"))
        self.transform = image_transform
        self._rng = random.Random(seed)

    def __len__(self):
        return len(self.reader)

    def __getitem__(self, idx: int) -> np.ndarray:
        image = np.asarray(self.reader[idx])
        if image.ndim == 2:
            image = image[..., None]
        if self.transform is not None:
            return self.transform(image[None], self._rng)[0].astype(np.float32)
        return image.astype(np.float32) / 255.0 - 0.5
