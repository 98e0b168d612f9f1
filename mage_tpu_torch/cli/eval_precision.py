"""Offline caption-based metrics: Action Precision and Referring-Expression
Precision of generated captions against the CATER ground truth.

Port of the root ``eval_precision.py`` (reference eval_precision.py:14-45):
the generated captions come from an external video-captioning run (the
reference README's SwinBERT), the ground truth from the dataset's
``test_{mode}.json``; prints the dataset means. ``--self-test`` checks the
parser and matcher on caption pairs with hand-computed precisions.
``--device`` is resolved first, as in every port CLI, though the metric
itself runs on the host.

    python -m mage_tpu_torch.cli.eval_precision --data-root ../datasets/CATER-GEN-v2 \\
        --gen-caption captions.json
    python -m mage_tpu_torch.cli.eval_precision --self-test --device cpu
"""

import argparse
import json
import os

from mage_tpu_torch.evals.precision import cross_check, sen_parse

SELF_TEST_CASES = [
    # (ground truth, generated, expected action P, expected RE P)
    ("the small gold snitch is sliding to (2,-2) .",
     "the small gold snitch is sliding to (2,-2) .", 1.0, 1.0),
    ("the small gold snitch is sliding to (2,-2) .",
     "the small gold snitch is rotating .", 0.0, 1.0),
    ("the medium red metal cone is picked up and placed to (1,3) .",
     "the medium blue metal cone is picked up and placed to (1,3) .", 1.0, 0.75),
    ("the large cyan rubber cone is picked up and containing the snitch .",
     "the large cyan rubber cone is sliding to (0,0) .", 0.0, 1.0),
    # two-action video: best-of-two bipartite matching
    ("the snitch is rotating . the medium purple metal cone is sliding to the fourth quadrant .",
     "the medium purple metal cone is sliding to the fourth quadrant . the snitch is rotating .",
     1.0, 1.0),
]


def self_test() -> int:
    """Runs the parser and matcher on ``SELF_TEST_CASES`` -> the number of
    cases whose precisions differ from the hand-computed ones."""
    failures = 0
    for gt, gen, exp_act, exp_re in SELF_TEST_CASES:
        a, r = cross_check(sen_parse(gt), sen_parse(gen))
        ok = abs(a - exp_act) < 1e-9 and abs(r - exp_re) < 1e-9
        failures += not ok
        print(f"{'ok  ' if ok else 'FAIL'} act={a} (want {exp_act}) "
              f"re={r} (want {exp_re}) :: {gen!r}")
    print("self-test:", "PASS" if failures == 0 else f"{failures} FAILURES")
    return failures


def main(argv=None):
    """-> (action precision, referring precision); ``--self-test`` exits
    with the number of failed cases."""
    from mage_tpu_torch.models.pipeline import resolve_device

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data-root", default="../datasets/CATER-GEN-v2")
    p.add_argument("--gen-caption", default=None,
                   help="JSON list of {image_id, caption} from the captioner")
    p.add_argument("--mode", default="ambiguous", choices=["explicit", "ambiguous"])
    p.add_argument("--self-test", action="store_true",
                   help="run the built-in metric self-check and exit")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cpu to run without a GPU)")
    args = p.parse_args(argv)
    resolve_device(args.device)

    if args.self_test:
        raise SystemExit(self_test())
    if not args.gen_caption:
        p.error("--gen-caption is required (or use --self-test)")

    with open(args.gen_caption) as fp:
        gen_captions = json.load(fp)
    with open(os.path.join(args.data_root, f"test_{args.mode}.json")) as fp:
        gt_captions = json.load(fp)
    by_video = {os.path.basename(v["video"]): v["caption"] for v in gt_captions.values()}

    n = 0
    p_act = p_re = 0.0
    for rec in gen_captions:
        video_id = os.path.splitext(rec["image_id"])[0] + ".avi"
        a, r = cross_check(sen_parse(by_video[video_id], mode=args.mode),
                           sen_parse(rec["caption"], mode=args.mode))
        p_act += a
        p_re += r
        n += 1
    print("Action_Precision: ", p_act / max(n, 1))
    print("Referring_Expression_Precision: ", p_re / max(n, 1))
    return p_act / max(n, 1), p_re / max(n, 1)


if __name__ == "__main__":
    main()
