"""Single Moving MNIST generator.

Capability parity with data/mnist_caption_single.py: one digit bouncing
vertically or horizontally for 20 frames at 64x64; caption
``"the digit D is moving <up then down|left then right|...> ."``; the
(digit, motion) pairs are disjoint between train and val (:32-45); writes
(video uint8 (20,64,64), caption str) records.

Usage:
    python -m mage_tpu_torch.data.generators.mnist_single --out data/moving_mnist \
        [--mnist-npz path] [--num-train 10000] [--num-val 2000] [--seed 0]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from mage_tpu_torch.data.generators import mnist_common as mc
from mage_tpu_torch.data.recordio import RecordWriter

SEQ_LENGTH = 20


def generate_instance(
    rng: np.random.RandomState,
    digit_img: np.ndarray,
    label: int,
    motion: int,
) -> tuple[np.ndarray, str]:
    direction = int(rng.randint(0, 2))
    track = mc.bounce_trajectory(SEQ_LENGTH, rng, motion, direction)
    video = mc.render_video([digit_img], [track], SEQ_LENGTH)
    caption = "the digit %d is moving %s ." % (
        label,
        mc.MOTION_STRINGS[motion + 2 * direction],
    )
    return video, caption


def generate_split(
    rng: np.random.RandomState,
    codes: np.ndarray,
    bank_images: np.ndarray,
    bank_labels: np.ndarray,
    num: int,
):
    digits = codes % 10
    motions = codes // 10
    out = []
    while len(out) < num:
        i = rng.randint(bank_images.shape[0])
        label = int(bank_labels[i])
        matches = np.where(digits == label)[0]
        if len(matches) == 0:
            continue
        motion = int(motions[rng.choice(matches)])
        out.append(generate_instance(rng, bank_images[i], label, motion))
    return out


def write_records(instances, path: str) -> None:
    with RecordWriter(path) as w:
        for video, caption in instances:
            w.append_pickle((video, caption))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="./data/moving_mnist")
    p.add_argument("--prefix", default="mnist_single_20f_10k_")
    p.add_argument("--mnist-npz", default=None)
    p.add_argument("--num-train", type=int, default=10000)
    p.add_argument("--num-val", type=int, default=2000)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    rng = np.random.RandomState(args.seed)
    images, labels = mc.load_digit_bank(args.mnist_npz, seed=args.seed)
    train_codes, val_codes = mc.digit_motion_split(rng)

    os.makedirs(args.out, exist_ok=True)
    train = generate_split(rng, train_codes, images, labels, args.num_train)
    write_records(train, os.path.join(args.out, args.prefix + "train.mrs"))
    val = generate_split(rng, val_codes, images, labels, args.num_val)
    write_records(val, os.path.join(args.out, args.prefix + "test.mrs"))
    print(
        f"wrote {len(train)} train / {len(val)} test records to "
        f"{args.out}/{args.prefix}{{train,test}}.mrs"
    )


if __name__ == "__main__":
    main()
