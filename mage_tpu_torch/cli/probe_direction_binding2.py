"""Per-digit direction binding of a Modified Double Moving MNIST model.

Port of the root ``probe_direction_binding2.py``, over a
``cli.train_mnist2_e2e`` run: the double-digit twin of
``probe_direction_binding``. The same first frame is generated at speed 0.5
under the true, the sign-swapped and the axis-swapped caption (per clause),
each captioned digit is template-tracked (``train_mnist2_e2e.track_digit``),
and its initial displacement is held against its own clause's first
direction word. A caption-blind model gives near-identical videos (pairwise
MSE about 0) and swapped-column agreement at chance. Digit cases with less
than ``--min-room`` px of head-room along the commanded direction are left
out per column; ``gt_ceiling`` runs the same window, gating and tracker on
ground-truth clips (``--ceiling-only``: that alone, no model). Prior noise
from a generator seeded 7.

Every flag this parser does not know goes to ``train_mnist2_e2e``'s parser
(the run's ``--num-train``, ``--num-val``, ``--tiny``, ...). ``--device``
(default ``cuda``) is resolved before any data is built.

    python -m mage_tpu_torch.cli.probe_direction_binding2 --run runs/mnist2_e2e
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from mage_tpu_torch.cli.probe_direction_binding import (
    AXIS_SWAP,
    DIR_TOKENS,
    SIGN_SWAP,
    VARIANTS,
    generate_variants,
    head_room,
    pair_mse,
    print_score,
    score,
    swap_tokens,
)

__all__ = ["AXIS_SWAP", "DIR_TOKENS", "SIGN_SWAP", "clause_directions", "swap_tokens"]

AND_TOKEN = 15
DIGITS = (("d1", "ys1", "xs1"), ("d2", "ys2", "xs2"))


def clause_directions(text_row):
    """First direction word of each digit's clause -> [(dy, dx), (dy, dx)].

    Captions are 'the digit D is moving <phrase> and the digit D is moving
    <phrase> .'; the single 'and' (token 15) separates the clauses
    (compound phrases use 'then', token 28). A clause without a direction
    token gives None."""
    toks = [int(t) for t in text_row]
    split = toks.index(AND_TOKEN) if AND_TOKEN in toks else len(toks)
    return [next((DIR_TOKENS[t] for t in seg if t in DIR_TOKENS), None)
            for seg in (toks[:split], toks[split:])]


def digit_displacement(video: np.ndarray, template: np.ndarray, y0: int, x0: int,
                       frames: int) -> tuple:
    """(L-1, 64, 64) frames -> the template-tracked top-left's displacement
    (dy, dx) at generated frame ``frames`` from the stored start (y0, x0)."""
    from mage_tpu_torch.cli.train_mnist2_e2e import track_digit

    tr = track_digit(video, template)
    return float(tr[frames - 1, 0] - y0), float(tr[frames - 1, 1] - x0)


def parse_args(argv=None):
    """-> (this CLI's arguments, ``train_mnist2_e2e``'s arguments for the run)."""
    from mage_tpu_torch.cli import train_mnist2_e2e

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--run", default="runs/mnist2_e2e")
    p.add_argument("--ckpt", default="final")
    p.add_argument("--videos", type=int, default=24)
    p.add_argument("--frames", type=int, default=1,
                   help="initial generated frames over which direction is measured: "
                        "'X then Y' phrases reflect at the commanded wall, so wide "
                        "windows corrupt the sign (the gt_ceiling line validates it)")
    p.add_argument("--min-room", type=int, default=12,
                   help="px of head-room required along the commanded direction for a "
                        "digit case to count")
    p.add_argument("--ceiling-only", action="store_true",
                   help="only the measurement ceiling on ground-truth clips; no model")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cpu runs the kernels' plain versions")
    args, rest = p.parse_known_args(argv)
    targs = train_mnist2_e2e.parse_args(["--out", args.run, "--device", args.device, *rest])
    return args, targs


def main(argv=None):
    from mage_tpu_torch.cli import train_mnist_e2e as tm
    from mage_tpu_torch.cli.eval_fvd_e2e import restore_run
    from mage_tpu_torch.cli.train_mnist2_e2e import frames_at
    from mage_tpu_torch.data import device_data as dd
    from mage_tpu_torch.models.pipeline import resolve_device

    args, targs = parse_args(argv)
    device = resolve_device(args.device)
    build = dd.build_compact_double_modified
    if args.ceiling_only:
        dev = tm.upload(build(targs.num_train, targs.num_val, targs.seed, targs.mnist_npz),
                        device)
    else:
        dev, model, pipeline = restore_run(targs, device, args.ckpt, build)
    val = dev["val"]
    g = min(args.videos, int(val["d1"].shape[0]))
    length = targs.frames_length
    span = dd.IMAGE_SIZE - dd.DIGIT_SIZE  # the valid top-left range [0, span]
    text_true = val["text"][:g]
    bank = dev["bank"].cpu().numpy()
    host = {k: v.cpu().numpy() for k, v in val.items() if k != "text"}

    def column(txt, vids):
        """vids (G, L-1, 64, 64): per-digit agreement with txt's clauses."""
        cases = []
        for i in range(g):
            for want, (dkey, ykey, xkey) in zip(clause_directions(txt[i]), DIGITS):
                y0, x0 = int(host[ykey][i, 0]), int(host[xkey][i, 0])
                room = head_room(want, y0, x0, span) if want else 0
                tmpl = bank[host[dkey][i]]
                cases.append((want, room, lambda v=vids[i], t=tmpl, y=y0, x=x0:
                              digit_displacement(v, t, y, x, args.frames)))
        return score(cases, args.min_room)

    # the measurement ceiling on the ground-truth clips at speed 0.5
    rows = torch.arange(g, device=device)
    pos = dd.clip_indices_var(torch.full((g,), 0.5, device=device), val["length"][:g], length)
    gt = frames_at(dev, "val", rows.repeat_interleave(length), pos.reshape(-1).long())
    gt = gt.reshape(g, length, *gt.shape[1:])[:, 1:, ..., 0].cpu().numpy()
    rec = {"run": args.run, "videos": g, "frames": args.frames, "min_room": args.min_room,
           "gt_ceiling": column(text_true.cpu().numpy(), gt)}
    print_score("gt_ceiling", rec["gt_ceiling"])
    if not args.ceiling_only:
        texts = {name: text_true if m is None else swap_tokens(text_true, m)
                 for name, m in VARIANTS.items()}
        f0 = frames_at(dev, "val", rows, torch.zeros_like(rows))
        with torch.no_grad():
            video = generate_variants(pipeline, model.encode(f0).to(torch.int32), texts)
        rec.update(pair_mse(video))
        print(f"\npairwise video MSE true-vs-sign_swap: {rec['mse_true_vs_sign_swap']:.3e}, "
              f"true-vs-axis_swap: {rec['mse_true_vs_axis_swap']:.3e}\n")
        video = video[..., 0].float().cpu().numpy()
        for vi, (name, txt) in enumerate(texts.items()):
            rec[name] = column(txt.cpu().numpy(), video[vi])
            print_score(name, rec[name])
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
