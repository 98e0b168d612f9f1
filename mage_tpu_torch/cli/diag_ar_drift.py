"""Where a discrete CATER run's semantic gap comes from: the teacher-forced
deficit or autoregressive drift.

Port of ``scripts/diag_ar_drift.py``. On the first ``G`` val clips, encoded
at the generation eval's speed-1.0 positions:

  (a) teacher-forced per-token argmax accuracy (one eval-mode forward),
      split into static tokens (the id equals the previous frame's) and
      moving ones: if moving-token accuracy is low here, the model never
      learned the dynamics, and more data or epochs is the lever;
  (b) the accuracy of an autoregressive rollout (``generate_cached`` from
      frame 0) per frame position: if (a) is high but the rollout decays
      with position, the gap is exposure bias, which data alone does not
      fix;

and the agreement of the rollout with the teacher-forced predictions.

It reads a ``cli.train_cater_e2e`` run (``<run>/vqvae/best``,
``<run>/mage/best``). Every flag this parser does not know goes to
``train_cater_e2e``'s parser: give the run's ``--dataset``, ``--num-train``,
``--num-val``, ``--seed`` (so the procedural val split is the run's) and
``--tiny``, ``--dim``, ...; the stage-2 config follows ``--dataset`` as in
``eval_speed_control_cater``. The stochastic branch's noise, where the core
has one, comes from generators seeded 0 (teacher-forced) and 7 (rollout).
The report goes to ``<run>/diag_ar_drift.json``, or to ``--report``.
``--device`` (default ``cuda``) is resolved before any data is built.

    python -m mage_tpu_torch.cli.diag_ar_drift --run runs/cater_e2e
"""

from __future__ import annotations

import argparse

import torch

from mage_tpu_torch.cli import train_cater_e2e as tc

G = 6  # val clips


def parse_args(argv=None):
    """-> (this CLI's arguments, ``train_cater_e2e``'s arguments for the run)."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--run", default="runs/cater_e2e")
    p.add_argument("--report", default=None, help="default: <run>/diag_ar_drift.json")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cpu runs the kernels' plain versions")
    args, rest = p.parse_known_args(argv)
    a = tc.parse_args(["--out", args.run, "--device", args.device, *rest])
    if a.config is None:
        a.config = f"config/mage_{a.dataset}.yaml"
    return args, a


def clip_frames(dev: dict, g: int, length: int) -> torch.Tensor:
    """The first ``g`` val clips at the speed-1.0 positions, composed in one
    flat call, clip-major -> (g * length, 128, 128, 3)."""
    device = dev["bank"].device
    pos = tc.clip_positions(torch.tensor(1.0, device=device), length).long()
    idx = torch.arange(g, device=device).repeat_interleave(length)
    return tc.frames_at(dev, "val", idx, pos.repeat(g))


@torch.no_grad()
def encode_ids(model, frames: torch.Tensor, g: int) -> torch.Tensor:
    """Clip-major frames -> ids (g, L, h, w) int32, in one encode."""
    ids = model.encode(frames)
    return ids.reshape(g, -1, *ids.shape[1:]).to(torch.int32)


def normal_draws(core, b: int, seed: int, n: int = 1) -> list:
    """``n`` standard normal (b, r, r, 64) draws, the stochastic branch's
    posterior and prior noise, from a generator seeded ``seed`` (where JAX
    draws from ``PRNGKey(seed)``); ``n`` Nones for a core without the
    branch."""
    if not core.randomness:
        return [None] * n
    device = next(core.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    r = core.image_resolution
    return [torch.randn((b, r, r, 64), generator=gen, device=device) for _ in range(n)]


@torch.no_grad()
def teacher_forced(core, latents, text, speed, test_flag: bool = False,
                   posterior_noise=None, video_noise=None) -> dict:
    """One teacher-forced forward in eval mode (JAX's ``train=False``: the
    spatial blocks run on the axial kernel) -> the core's outputs."""
    core.eval()
    return core(latents, text, speed, test_flag=test_flag,
                posterior_noise=posterior_noise, video_noise=video_noise)


def share(hit: torch.Tensor, mask=None) -> float:
    """The share of true ``hit`` (within ``mask``), from exact counts as
    numpy's mean of a bool array gives it; nan over an empty mask."""
    if mask is None:
        return int(hit.sum()) / hit.numel()
    n = int(mask.sum())
    return int((hit & mask).sum()) / n if n else float("nan")


def drift_report(tf_ids: torch.Tensor, gen_ids: torch.Tensor, gt: torch.Tensor) -> dict:
    """Teacher-forced and rollout ids (G, L-1, h, w) against the encoded
    clips (G, L, h, w) -> accuracies overall, on moving and static tokens
    and per position, and the rollout's agreement with teacher forcing."""
    labels, prev = gt[:, 1:], gt[:, :-1]
    moving = labels != prev
    tf_ok, gen_ok = tf_ids == labels, gen_ids == labels

    def split(ok):
        return {"all": share(ok), "moving": share(ok, moving), "static": share(ok, ~moving)}

    return {
        "phase": "diag_ar_drift", "videos": int(gt.shape[0]), "tokens": labels.numel(),
        "moving_fraction": share(moving),
        "teacher_forced": split(tf_ok), "rollout": split(gen_ok),
        "per_position": [{"pos": j + 1,
                          "tf_all": share(tf_ok[:, j]), "tf_moving": share(tf_ok[:, j],
                                                                           moving[:, j]),
                          "gen_all": share(gen_ok[:, j]), "gen_moving": share(gen_ok[:, j],
                                                                              moving[:, j])}
                         for j in range(labels.shape[1])],
        "agreement": share(gen_ids == tf_ids),
    }


def main(argv=None):
    from mage_tpu_torch.cli.eval_speed_control_cater import load_run
    from mage_tpu_torch.models.pipeline import resolve_device
    from mage_tpu_torch.training import e2e

    args, a = parse_args(argv)
    device = resolve_device(args.device)
    dev, model, pipeline = load_run(a, device)
    core = pipeline.core
    g = min(G, int(dev["val"]["sid"].shape[0]))
    ids = encode_ids(model, clip_frames(dev, g, a.frames_length), g)
    print("encoded", tuple(ids.shape))
    text = dev["val"]["text"][:g]
    speed = torch.full((g,), 1.0, dtype=torch.float32, device=device)
    (post,), (video,) = normal_draws(core, g, 0), normal_draws(core, g, 7)
    tf_ids = teacher_forced(core, ids, text, speed, posterior_noise=post)["predict"]
    tf_ids = tf_ids.argmax(dim=-1).to(torch.int32)
    gen_ids = core.generate_cached(ids[:, :1], text, speed, video_noise=video)
    rec = dict(drift_report(tf_ids, gen_ids, ids), run=args.run)

    print(f"tokens: {rec['tokens']}, moving fraction {rec['moving_fraction']:.4f}")
    for name, key in (("teacher-forced", "teacher_forced"), ("AR rollout   ", "rollout")):
        r = rec[key]
        print(f"{name} acc: all {r['all']:.4f}  moving {r['moving']:.4f}  "
              f"static {r['static']:.4f}")
    print("per-frame acc (position 1..L-1):")
    for r in rec["per_position"]:
        print(f"  t={r['pos']}: tf all {r['tf_all']:.4f} moving {r['tf_moving']:.4f} | "
              f"gen all {r['gen_all']:.4f} moving {r['gen_moving']:.4f}")
    print(f"gen-vs-tf agreement: {rec['agreement']:.4f}")
    e2e.write_report(rec, args.run, "diag_ar_drift", args.report)
    return rec


if __name__ == "__main__":
    main()
