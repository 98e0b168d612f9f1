"""CATER-GEN caption annotation generator.

Capability parity with data/gen_cater_text_anno.py: reads CATER
``scenes/*.json`` metadata, skips broken/unrendered videos, takes the first
MAX videos, 80/20 shuffled split (seed 42), and emits per-movement caption
clauses — slide / rotate / pick-place / contain (:152-166). ``explicit``
mode names all attributes + a grid coordinate; ``ambiguous`` mode uses a
random attribute subset + quadrant (:98-102, 140-148); CATER-GEN-v1 uses
shape-only names (:149-150). Writes ``{split}_{mode}.json``.

Broken-video detection: the reference shells out to ffmpeg/ffprobe
(:23-44); this environment has no ffmpeg, so the check uses cv2 frame
counting (same contract: skip ``.lock`` files and videos with fewer frames
than the movement metadata requires).

Usage:
    python -m mage_tpu_torch.data.generators.cater_text_anno \
        --data-dir ./data/CATER-GEN-v2 --mode explicit --dataset CATER-GEN-v2
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os.path as osp
import random

import numpy as np

SHAPE_TO_NAME = {
    "spl": "snitch", "sphere": "sphere", "cylinder": "cylinder",
    "cube": "cube", "cone": "cone",
}
NUM_ROWS = NUM_COLS = 3


def check_avi_broken(fpath: str, max_frame: int) -> bool:
    if osp.exists(fpath + ".lock"):
        return True
    if not osp.exists(fpath):
        return True
    try:
        from mage_tpu_torch.data.video import VideoReader

        vid = VideoReader(fpath)
        n = len(vid)
        vid.release()
    except Exception:
        return True
    return max_frame > n


def find_quadrant(x: float, y: float) -> str:
    if x >= 0 and y >= 0:
        return "the first quadrant"
    if x < 0 <= y:
        return "the second quadrant"
    if x < 0 and y < 0:
        return "the third quadrant"
    return "the fourth quadrant"


def coordinate_2d(raw_x, raw_y, num_rows=NUM_ROWS, num_cols=NUM_COLS):
    if num_rows != NUM_ROWS or num_cols != NUM_COLS:
        raw_x *= num_cols * 1.0 / NUM_COLS
        raw_y *= num_rows * 1.0 / NUM_ROWS
    if -num_rows < raw_x <= 0:
        raw_x -= 1
    if -num_cols < raw_y <= 0:
        raw_y -= 1
    return int(math.ceil(raw_x)), int(math.ceil(raw_y))


def coarse_attribute(obj_id: int, objects, rng: random.Random) -> str:
    num = rng.choice(range(0, 4))
    attrs = rng.sample(
        [objects[obj_id]["size"], objects[obj_id]["color"], objects[obj_id]["material"]],
        num,
    )
    attrs.append(SHAPE_TO_NAME[objects[obj_id]["shape"]])
    return "the " + " ".join(attrs)


def object_phrase(obj_id: int, objects, mode: str, dataset: str, rng) -> str:
    if dataset == "CATER-GEN-v1":
        return "the {}".format(SHAPE_TO_NAME[objects[obj_id]["shape"]])
    if mode == "ambiguous":
        return coarse_attribute(obj_id, objects, rng)
    o = objects[obj_id]
    return "the {} {} {} {}".format(
        o["size"], o["color"], o["material"], SHAPE_TO_NAME[o["shape"]]
    )


def caption_for_scene(metadata: dict, mode: str, dataset: str, rng) -> str:
    movements = metadata["movements"]
    objects = metadata["objects"]
    anno = ""
    for sbj_name, item in movements.items():
        if item == []:
            continue
        sbj_id = [i for i, x in enumerate(objects) if x["instance"] == sbj_name][0]
        action, obj_name, _start, _end = item[0]
        locs = objects[sbj_id]["locations"]
        final_pos = locs[str(len(locs) - 1)]
        sbj_anno = object_phrase(sbj_id, objects, mode, dataset, rng)
        if mode == "ambiguous":
            x = find_quadrant(final_pos[0], final_pos[1])
        else:
            x1, y1 = coordinate_2d(final_pos[0], final_pos[1], 3, 3)
            x = "({}, {})".format(x1, y1)
        if action == "_slide":
            anno += " {} is sliding to {}.".format(sbj_anno, x)
        if action == "_rotate":
            anno += " {} is rotating.".format(sbj_anno)
        if action == "_pick_place":
            anno += " {} is picked up and placed to {}.".format(sbj_anno, x)
        if action == "_contain":
            obj_id = [i for i, o in enumerate(objects) if o["instance"] == obj_name][0]
            obj_anno = object_phrase(obj_id, objects, mode, dataset, rng)
            anno += " {} is picked up and containing {}.".format(sbj_anno, obj_anno)
    return anno


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-dir", required=True)
    p.add_argument("--mode", default="explicit", choices=["explicit", "ambiguous"])
    p.add_argument("--dataset", default="CATER-GEN-v2",
                   choices=["CATER-GEN-v1", "CATER-GEN-v2"])
    p.add_argument("--max-videos", type=int, default=30000)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--skip-video-check", action="store_true")
    args = p.parse_args(argv)

    rng = random.Random(args.seed)
    np.random.seed(args.seed)

    scene_files = sorted(glob.glob(osp.join(args.data_dir, "scenes/*.json")))
    data = {}
    for scene_file in scene_files:
        try:
            with open(scene_file) as fin:
                metadata = json.load(fin)
            vid_name = (
                osp.splitext(scene_file.replace("/scenes/", "/videos/"))[0] + ".avi"
            )
            if not args.skip_video_check:
                max_frame = max(
                    ii[-1] for i in metadata["movements"].values() for ii in i
                )
                if check_avi_broken(vid_name, max_frame):
                    continue
            data[vid_name] = metadata
            if len(data) > args.max_videos:
                break
        except Exception as e:  # noqa: BLE001 — unreadable scene files are skipped
            print(f"Unable to read {scene_file}: {e}")
    print(f"Found {len(data)} good videos out of {len(scene_files)}")

    items = list(data.items())[: args.max_videos]
    np.random.shuffle(items)
    cut = int(0.8 * len(items))
    splits = {"train": items[:cut], "test": items[cut:]}

    for split, split_data in splits.items():
        split_anno = {}
        for idx, (vid_name, metadata) in enumerate(split_data):
            video_path = "/".join(vid_name.split("/")[-2:])
            split_anno[idx] = {
                "video": video_path,
                "caption": caption_for_scene(metadata, args.mode, args.dataset, rng),
            }
        out = osp.join(args.data_dir, f"{split}_{args.mode}.json")
        with open(out, "w") as fp:
            json.dump(split_anno, fp)
        print(f"wrote {len(split_anno)} annotations to {out}")


if __name__ == "__main__":
    main()
