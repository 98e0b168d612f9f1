"""Modified Double Moving MNIST generator.

Capability parity with data/mnist_caption_double_modified.py: two digits
with per-digit stop-at-wall vs bounce behavior (8 motion strings including
one-way "up/left/down/right", :30), start positions U{0.15..0.85} (:78-79),
trajectories that freeze once velocity hits zero (:132-133), and a random
static distractor digit placed with an IOU<=0.7 check against both moving
digits' start boxes (:169-181). 24k train / 6k val by default (:244-282).

Usage:
    python -m mage_tpu_torch.data.generators.mnist_double_modified --out data/moving_mnist
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from mage_tpu_torch.data.generators import mnist_common as mc
from mage_tpu_torch.data.generators.mnist_double import MOTION_IDXS, pair_motion_split

SEQ_LENGTH = 20
MOTION_STRINGS = [
    "up", "left", "down", "right",
    "up then down", "left then right", "down then up", "right then left",
]


def modified_trajectory(rng, motion: int, direction: int, bounce: int):
    """Reference :74-139. bounce=0: stop at the first wall. bounce=1:
    reflect at the far wall, stop on returning to the near wall. The track
    ends early once the digit stops; length <= SEQ_LENGTH + 1."""
    y = rng.randint(15, 85) / 100.0
    x = rng.randint(15, 85) / 100.0
    v_y, v_x = (2.0, 0.0) if motion == 0 else (0.0, 2.0)
    if direction == 0:
        v_y, v_x = -v_y, -v_x
    ys, xs = [y], [x]
    for _ in range(SEQ_LENGTH):
        y += v_y * mc.STEP_LENGTH
        x += v_x * mc.STEP_LENGTH
        if direction == 1:
            if bounce == 0:
                if x >= 1.0:
                    x, v_x = 1.0, 0.0
                if y >= 1.0:
                    y, v_y = 1.0, 0.0
            else:
                if x >= 1.0:
                    x, v_x = 1.0, -v_x
                if y >= 1.0:
                    y, v_y = 1.0, -v_y
                if x <= 0.0:
                    x, v_x = 0.0, 0.0
                if y <= 0.0:
                    y, v_y = 0.0, 0.0
        else:
            if bounce == 0:
                if x <= 0.0:
                    x, v_x = 0.0, 0.0
                if y <= 0.0:
                    y, v_y = 0.0, 0.0
            else:
                if x <= 0.0:
                    x, v_x = 0.0, -v_x
                if y <= 0.0:
                    y, v_y = 0.0, -v_y
                if x >= 1.0:
                    x, v_x = 1.0, 0.0
                if y >= 1.0:
                    y, v_y = 1.0, 0.0
        ys.append(y)
        xs.append(x)
        if v_y == 0.0 and v_x == 0.0:
            break
    return (
        (mc.CANVAS * np.asarray(ys)).astype(np.int32),
        (mc.CANVAS * np.asarray(xs)).astype(np.int32),
    )


def _iou_overlaps(box1, box2, threshold=0.7) -> bool:
    top = max(box1[0], box2[0]); left = max(box1[1], box2[1])
    bottom = min(box1[2], box2[2]); right = min(box1[3], box2[3])
    inter = max(0, right - left) * max(0, bottom - top)
    iou = inter / float(mc.DIGIT_SIZE**2 * 2 - inter)
    return iou > threshold


def generate_instance(rng, digit_imgs, labels, combo, background):
    motions = MOTION_IDXS[combo]
    tracks, dirs, bounces = [], [], []
    for m in motions:
        d, bn = int(rng.randint(0, 2)), int(rng.randint(0, 2))
        tracks.append(modified_trajectory(rng, int(m), d, bn))
        dirs.append(d)
        bounces.append(bn)
    # pad to common length (reference :152-157)
    tlen = max(t[0].shape[0] for t in tracks)
    tracks = [
        (np.pad(ys, (0, tlen - len(ys)), mode="edge"),
         np.pad(xs, (0, tlen - len(xs)), mode="edge"))
        for ys, xs in tracks
    ]

    overlays = []
    if rng.randint(0, 2) == 1:  # static distractor digit (:169-181)
        boxes = [
            (int(t[0][0]), int(t[1][0]),
             int(t[0][0]) + mc.DIGIT_SIZE, int(t[1][0]) + mc.DIGIT_SIZE)
            for t in tracks
        ]
        while True:
            top = int((mc.IMAGE_SIZE - mc.DIGIT_SIZE) * rng.rand())
            left = int((mc.IMAGE_SIZE - mc.DIGIT_SIZE) * rng.rand())
            box = (top, left, top + mc.DIGIT_SIZE, left + mc.DIGIT_SIZE)
            if not any(_iou_overlaps(box, b) for b in boxes):
                break
        overlays.append((background, top, left))

    video = mc.render_video(list(digit_imgs), tracks, tlen, static_overlays=overlays)
    caption = "the digit %d is moving %s and the digit %d is moving %s ." % (
        labels[0], MOTION_STRINGS[int(motions[0]) + 2 * dirs[0] + 4 * bounces[0]],
        labels[1], MOTION_STRINGS[int(motions[1]) + 2 * dirs[1] + 4 * bounces[1]],
    )
    return video, caption


def generate_split(rng, codes, bank_images, bank_labels, num):
    pair_codes = codes % 100
    combo_codes = codes // 100
    out = []
    while len(out) < num:
        idxs = rng.randint(bank_images.shape[0], size=2)
        pair = 10 * int(bank_labels[idxs[0]]) + int(bank_labels[idxs[1]])
        matches = np.where(pair_codes == pair)[0]
        if len(matches) == 0:
            continue
        combo = int(combo_codes[rng.choice(matches)])
        # distractor must differ from both moving digits (:172-174)
        while True:
            bg = rng.randint(bank_images.shape[0])
            if bank_labels[bg] not in (bank_labels[idxs[0]], bank_labels[idxs[1]]):
                break
        out.append(
            generate_instance(
                rng, bank_images[idxs], bank_labels[idxs].tolist(), combo,
                bank_images[bg],
            )
        )
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="./data/moving_mnist")
    p.add_argument("--prefix", default="mnist_double_modified_20f_24k_")
    p.add_argument("--mnist-npz", default=None)
    p.add_argument("--num-train", type=int, default=24000)
    p.add_argument("--num-val", type=int, default=6000)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    rng = np.random.RandomState(args.seed)
    images, labels = mc.load_digit_bank(args.mnist_npz, seed=args.seed)
    train_codes, val_codes = pair_motion_split(rng)

    os.makedirs(args.out, exist_ok=True)
    from mage_tpu_torch.data.generators.mnist_single import write_records

    train = generate_split(rng, train_codes, images, labels, args.num_train)
    write_records(train, os.path.join(args.out, args.prefix + "train.mrs"))
    val = generate_split(rng, val_codes, images, labels, args.num_val)
    write_records(val, os.path.join(args.out, args.prefix + "test.mrs"))
    print(f"wrote {len(train)} train / {len(val)} test records")


if __name__ == "__main__":
    main()
