"""Flatten CATER videos into the per-image stage-1 store ``vqvae_{split}``.

The reference's stage-1 CATER dataset reads a pre-flattened per-image LMDB
``vqvae_{split}.lmdb`` whose creation is an external preparation step the
repo never ships (reference: dataload.py:384-400, note at :391 "generated
beforehand"). This CLI closes that gap: it walks the ``{split}_{mode}.json``
annotations produced by ``cater_text_anno`` (so the stage-1 store covers
exactly the videos stage 2 trains on, with the same train/test split),
decodes each video with the in-repo cv2 ``VideoReader``, subsamples frames
at a fixed stride, and writes uint8 RGB frames into the repo's record
store (``.mrs``) that ``CATER4VQVAE`` opens via ``open_blob_store``.

Usage (after cater_synthetic + cater_text_anno):
    python -m mage_tpu_torch.data.generators.cater_vqvae_store \
        --data-dir ./data/CATER-SYN --mode explicit --stride 4
then:
    python train_vqvae.py --dataset cater_gen --data-root ./data/CATER-SYN/
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp

import numpy as np


def build_store(data_dir: str, split: str, mode: str, stride: int) -> int:
    from mage_tpu_torch.data.recordio import RecordWriter
    from mage_tpu_torch.data.video import VideoReader

    anno_path = osp.join(data_dir, f"{split}_{mode}.json")
    with open(anno_path) as fp:
        anno = json.load(fp)
    out_path = osp.join(data_dir, f"vqvae_{split}.mrs")
    n = 0
    with RecordWriter(out_path) as wr:
        for idx in sorted(anno, key=int):
            path = osp.join(data_dir, anno[idx]["video"])
            vid = VideoReader(path)
            frames = vid.get_batch(list(range(0, len(vid), stride)))
            vid.release()
            for frame in np.asarray(frames, np.uint8):
                wr.append_pickle(frame)
                n += 1
    print(f"wrote {n} frames from {len(anno)} videos to {out_path}")
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-dir", required=True,
                   help="dataset root containing videos/ and the "
                        "{split}_{mode}.json annotations")
    p.add_argument("--mode", default="explicit",
                   choices=["explicit", "ambiguous"])
    p.add_argument("--stride", type=int, default=4,
                   help="keep every stride-th frame of each video")
    args = p.parse_args(argv)
    for split in ("train", "test"):
        build_store(args.data_dir, split, args.mode, args.stride)


if __name__ == "__main__":
    main()
