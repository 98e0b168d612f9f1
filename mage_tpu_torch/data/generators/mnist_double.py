"""Double Moving MNIST generator.

Capability parity with data/mnist_caption_double.py: two digits, each with
its own vertical/horizontal bounce trajectory (start positions U{0.15..0.85},
:81-83); captions join two clauses; the (digit-pair, motion-combo) codes are
split between train and val with alternating assignment over the 90 ordered
non-equal digit pairs x 4 motion combos (:36-58).

Usage:
    python -m mage_tpu_torch.data.generators.mnist_double --out data/moving_mnist
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from mage_tpu_torch.data.generators import mnist_common as mc

SEQ_LENGTH = 20
MOTION_IDXS = np.array([[0, 0], [0, 1], [1, 0], [1, 1]])


def pair_motion_split(rng: np.random.RandomState):
    """Codes ``pair + 100*combo`` (pair = 10*a+b, a != b), combos 0..3,
    alternating train/val assignment (reference :36-58)."""
    pairs = np.array([i for i in range(100) if i // 10 != i % 10])
    rng.shuffle(pairs)
    train, val = [], []
    count = 0
    for block in (0, 2):  # combos {0,1} then {2,3}
        for i in range(90):
            dummy = count % 2
            val.append(pairs[i] + 100 * (block + dummy))
            train.append(pairs[i] + 100 * (block + 1 - dummy))
            count += 1
    return np.asarray(train), np.asarray(val)


def _start(rng):
    return (rng.randint(15, 85) / 100.0, rng.randint(15, 85) / 100.0)


def generate_instance(rng, digit_imgs, labels, combo):
    motions = MOTION_IDXS[combo]
    tracks, directions = [], []
    for m in motions:
        d = int(rng.randint(0, 2))
        tracks.append(
            mc.bounce_trajectory(SEQ_LENGTH, rng, int(m), d, start=_start(rng))
        )
        directions.append(d)
    video = mc.render_video(list(digit_imgs), tracks, SEQ_LENGTH)
    caption = "the digit %d is moving %s and the digit %d is moving %s ." % (
        labels[0],
        mc.MOTION_STRINGS[int(motions[0]) + 2 * directions[0]],
        labels[1],
        mc.MOTION_STRINGS[int(motions[1]) + 2 * directions[1]],
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
        out.append(
            generate_instance(
                rng, bank_images[idxs], bank_labels[idxs].tolist(), combo
            )
        )
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="./data/moving_mnist")
    p.add_argument("--prefix", default="mnist_double_20f_10k_")
    p.add_argument("--mnist-npz", default=None)
    p.add_argument("--num-train", type=int, default=10000)
    p.add_argument("--num-val", type=int, default=2000)
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
