"""Per-position motion decay of a MAGE+ CATER run's rollout against teacher
forcing.

Port of ``scripts/diag_magep_drift.py``, the follow-up to
``diag_magep_semantic``. The rollout's slot 1 conditions on the inputs of
the teacher-forced position 1 (frame 0 and the anchor), so if the
generation's motion dies only at later positions the mechanism is
compounding feedback (exposure bias): the blurred prediction fed back in is
conservative, the next step conditions on a near-static context and
regresses further.

On ``diag_magep_semantic``'s set-up (``load_run``: the same clips, sample
and means) it runs one teacher-forced forward with a prior sample
(``test_flag=True``, the generation path; both normals from a generator
seeded 7) and one ``generate_cached`` rollout with that same prior sample,
so slot 1 sees the same inputs in both (JAX's rollout draws its prior
anew). Per position it reports the MSE on moving tokens (the top 10% of the
means' temporal energy) of both against the means, the ground truth's step
energy there, and from position 2 the motion of both streams; the slot-1
agreement beside it.

Flags as ``diag_magep_semantic``'s. The report goes to
``<run>/diag_magep_drift.json``, or to ``--report``.

    python -m mage_tpu_torch.cli.diag_magep_drift --run runs/cater_kl_9k
"""

from __future__ import annotations

import torch

from mage_tpu_torch.cli.diag_ar_drift import normal_draws, teacher_forced
from mage_tpu_torch.cli.diag_magep_semantic import load_run, motion_mask, parse_args


def _masked_mean(x: torch.Tensor, mask: torch.Tensor):
    return float(x[mask].mean()) if bool(mask.any()) else None


def drift_rows(tf_pred: torch.Tensor, gen: torch.Tensor, means: torch.Tensor) -> dict:
    """Teacher-forced and rollout predictions (G, L-1, h, w, z) f32 against
    the posterior means (G, L, h, w, z) -> the slot-1 agreement and the
    per-position rows of JAX's report (None where no token moves)."""
    target = means[:, 1:]
    d2, _, moving = motion_mask(means)
    rows = []
    for j in range(target.shape[1]):
        m = moving[:, j]
        row = {"pos": j + 1,
               "tf_mse_moving": _masked_mean(((tf_pred[:, j] - target[:, j]) ** 2).mean(-1), m),
               "gen_mse_moving": _masked_mean(((gen[:, j] - target[:, j]) ** 2).mean(-1), m),
               "gt_step_energy": _masked_mean(d2[:, j], m)}
        if j > 0:
            row["tf_motion"] = _masked_mean(((tf_pred[:, j] - tf_pred[:, j - 1]) ** 2
                                             ).mean(-1), m)
            row["gen_motion"] = _masked_mean(((gen[:, j] - gen[:, j - 1]) ** 2).mean(-1), m)
        rows.append(row)
    return {"slot1_mse": float(((tf_pred[:, 0] - gen[:, 0]) ** 2).mean()),
            "slot1_signal_msq": float((tf_pred[:, 0] ** 2).mean()),
            "rows": rows}


def main(argv=None):
    from mage_tpu_torch.models.pipeline import resolve_device
    from mage_tpu_torch.training import e2e

    args, a = parse_args(argv, __doc__)
    device = resolve_device(args.device)
    run = load_run(a, device)
    core, lat, text, speed = run["core"], run["latents"], run["text"], run["speed"]
    post, prior = normal_draws(core, lat.shape[0], 7, 2)
    tf_pred = teacher_forced(core, lat, text, speed, test_flag=True, posterior_noise=post,
                             video_noise=prior)["predict"].float()
    gen = core.generate_cached(lat[:, :1], text, speed, video_noise=prior).float()
    rec = {"phase": "diag_magep_drift", "out": args.run, "samples": int(lat.shape[0]),
           **drift_rows(tf_pred, gen, run["means"])}
    print(f"slot-1 agreement: tf[:,0] vs gen[:,0] mse {rec['slot1_mse']:.6f} "
          f"(signal msq {rec['slot1_signal_msq']:.4f})")
    for row in rec["rows"]:
        print(row)
    e2e.write_report(rec, args.run, "diag_magep_drift", args.report)
    return rec


if __name__ == "__main__":
    main()
