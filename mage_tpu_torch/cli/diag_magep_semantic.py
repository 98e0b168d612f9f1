"""Where a MAGE+ CATER run's semantic gap comes from: a posterior leak or
MSE blurring.

Port of ``scripts/diag_magep_semantic.py``. Generations of a MAGE+ run on
ambiguous quadrant captions may never translate objects. Two mechanisms
tell apart on the run's checkpoints:

  (A) posterior leak: at train time the video posterior carries the motion
      trajectory, so the decoder never learns to read motion from the
      text, and at test time a prior sample carries none. Signature: the
      teacher-forced MSE on moving tokens is much lower with the posterior
      sample than with a prior sample.
  (B) MSE blurring: under an ambiguous caption the endpoint is
      under-determined, and MSE training regresses to the mean position.
      Signature: posterior and prior teacher-forced moving MSE about equal,
      and the predictions' motion energy far below the ground truth's on
      moving tokens in both.

On the first ``G`` val clips at the speed-1.0 positions it computes the
KL-AE's posterior moments, one posterior sample (the training inputs; its
normal from a generator seeded 3) and the means (the motion mask: the top
10% of the means' temporal energy), the teacher-forced predictions and KL
under the posterior (``test_flag=False``) and a prior sample
(``test_flag=True``; both normals from a generator seeded 11), and one
``generate_cached`` rollout (its prior from a generator seeded 7).

It reads a ``cli.train_cater_kl_e2e`` run (``<run>/klae/best``,
``<run>/mage/final``): ``--num-train``, ``--num-val`` and ``--v-kl`` default
to the 9k-scene run's, and every flag this parser does not know goes to
``train_cater_kl_e2e``'s parser (the run's ``--seed``, ``--tiny``,
``--ae-ch``, ``--frames-length``, ...). The report goes to
``<run>/diag_magep_semantic.json``, or to ``--report``. ``--device``
(default ``cuda``) is resolved before any data is built.

    python -m mage_tpu_torch.cli.diag_magep_semantic --run runs/cater_kl_9k
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from mage_tpu_torch.cli.diag_ar_drift import clip_frames, normal_draws, share, teacher_forced

G = 16  # val clips


def parse_args(argv=None, description: str = __doc__):
    """-> (this CLI's arguments, ``train_cater_kl_e2e``'s arguments for the
    run)."""
    from mage_tpu_torch.cli import train_cater_kl_e2e as ke

    p = argparse.ArgumentParser(description=description,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--run", default="runs/cater_kl_9k")
    p.add_argument("--num-train", type=int, default=9000)
    p.add_argument("--num-val", type=int, default=600)
    p.add_argument("--v-kl", type=float, default=25.0)
    p.add_argument("--report", default=None,
                   help="default: <run>/<this tool's name>.json")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cpu runs the kernels' plain versions")
    args, rest = p.parse_known_args(argv)
    a = ke.parse_args(["--out", args.run, "--v-kl", str(args.v_kl), "--num-train",
                       str(args.num_train), "--num-val", str(args.num_val), "--device",
                       args.device, *rest])
    return args, a


@torch.no_grad()
def encode_moments(model, frames: torch.Tensor, g: int) -> torch.Tensor:
    """Clip-major frames -> posterior moments (g, L, h, w, 2 z) f32, in one
    encode."""
    mom = model.encode_moments(frames).float()
    return mom.reshape(g, -1, *mom.shape[1:])


def load_run(a, device) -> dict:
    """The MAGE+ diagnostics' shared set-up: the run's CATER-GEN-v2 val
    split with ambiguous captions, its KL-AE (``klae/best``) and MAGE+ core
    (``mage/final``), and for the first ``min(G, val clips)`` clips at the
    speed-1.0 positions the posterior moments, one posterior sample (f32 of
    its bf16 value, as the chain's training inputs; the logvar shifted by
    ``--posterior-logvar-shift``; its normal from a generator seeded 3) and
    the posterior means -> {"core", "latents", "means", "text", "speed"}."""
    from mage_tpu_torch.cli import train_cater_e2e as ce
    from mage_tpu_torch.cli import train_cater_kl_e2e as ke
    from mage_tpu_torch.cli import train_mnist_kl_e2e as mkl
    from mage_tpu_torch.data.generators import cater_synthetic as cs
    from mage_tpu_torch.models.autoencoder_kl import DiagonalGaussian
    from mage_tpu_torch.training.checkpoint import Checkpointer

    dev = ce.upload(cs.build_compact_cater(a.num_train, a.num_val, a.seed, mode="ambiguous",
                                           dataset="CATER-GEN-v2", context_length=38),
                    device)
    model = ke.make_ae(a, device)
    model.load_state_dict(Checkpointer(os.path.join(a.out, "klae")).restore(
        "best", device)["state_dict"])
    model.eval()
    pipeline = ke.build_pipeline(a, model, device)
    pipeline.core.load_state_dict(Checkpointer(os.path.join(a.out, "mage")).restore(
        "final", device)["model"])
    g = min(G, int(dev["val"]["sid"].shape[0]))
    mom = encode_moments(model, clip_frames(dev, g, a.frames_length), g)
    gen = torch.Generator(device=device).manual_seed(3)
    noise = torch.randn((*mom.shape[:-1], mom.shape[-1] // 2), generator=gen, device=device)
    return {"core": pipeline.core,
            "latents": mkl.sample_latents(mom, None, a.posterior_logvar_shift,
                                          noise=noise).float(),
            "means": DiagonalGaussian(mom).mode(),
            "text": dev["val"]["text"][:g],
            "speed": torch.full((g,), 1.0, dtype=torch.float32, device=device)}


def motion_mask(means: torch.Tensor):
    """The posterior means' per-token temporal energy d2 (G, L-1, h, w) ->
    (d2, its 0.90 quantile (linear, as numpy's), the mask d2 > it)."""
    d2 = ((means[:, 1:] - means[:, :-1]) ** 2).mean(dim=-1)
    thresh = torch.quantile(d2.flatten(), 0.90)
    return d2, thresh, d2 > thresh


def semantic_report(pred_post, pred_prior, gen, latents, means, kl) -> dict:
    """The teacher-forced predictions under the posterior and the prior and
    the rollout, each (G, L-1, h, w, z) f32, against the sampled latents'
    frames 1.. -> JAX's report keys: MSEs overall and on moving and static
    tokens, motion energies on moving tokens, posterior-vs-prior
    divergence."""
    target = latents[:, 1:]
    _, _, moving = motion_mask(means)
    rec = {"kl_nats": float(kl), "moving_frac": share(moving), "samples": int(latents.shape[0])}

    def mse(pred, mask=None):
        e = ((pred - target) ** 2).mean(dim=-1)
        return float(e[mask].mean() if mask is not None else e.mean())

    for name, pred in (("posterior", pred_post), ("prior", pred_prior)):
        rec[f"tf_{name}_mse_all"] = mse(pred)
        rec[f"tf_{name}_mse_moving"] = mse(pred, moving)
        rec[f"tf_{name}_mse_static"] = mse(pred, ~moving)

    def motion_energy(x):  # does the stream move where the ground truth moves?
        d = ((x[:, 1:] - x[:, :-1]) ** 2).mean(dim=-1)
        return float(d[moving[:, 1:]].mean())

    rec["gt_moving_energy"] = motion_energy(means[:, 1:])
    rec["tf_posterior_moving_energy"] = motion_energy(pred_post)
    rec["tf_prior_moving_energy"] = motion_energy(pred_prior)
    rec["gen_moving_energy"] = motion_energy(gen)
    # how much the sample changes the prediction (the leak's bandwidth)
    dp = ((pred_post - pred_prior) ** 2).mean(dim=-1)
    rec["pred_post_vs_prior_mse_moving"] = float(dp[moving].mean())
    rec["pred_post_vs_prior_mse_static"] = float(dp[~moving].mean())
    return rec


def main(argv=None):
    from mage_tpu_torch.models.pipeline import resolve_device
    from mage_tpu_torch.training import e2e

    args, a = parse_args(argv)
    device = resolve_device(args.device)
    run = load_run(a, device)
    core, lat, text, speed = run["core"], run["latents"], run["text"], run["speed"]
    g = lat.shape[0]
    print("encoded latents", tuple(lat.shape))
    post, prior = normal_draws(core, g, 11, 2)
    out_post = teacher_forced(core, lat, text, speed, posterior_noise=post)
    out_prior = teacher_forced(core, lat, text, speed, test_flag=True, posterior_noise=post,
                               video_noise=prior)
    (video,) = normal_draws(core, g, 7)
    gen = core.generate_cached(lat[:, :1], text, speed, video_noise=video).float()
    _, thresh, moving = motion_mask(run["means"])
    print(f"moving mask: {share(moving):.4f} of tokens, d2 thresh {float(thresh):.5f}")
    rec = {"phase": "diag_magep_semantic", "out": args.run,
           **semantic_report(out_post["predict"].float(), out_prior["predict"].float(), gen,
                             lat, run["means"], out_post["kl_loss"])}
    print(json.dumps(rec, indent=2))
    e2e.write_report(rec, args.run, "diag_magep_semantic", args.report)
    return rec


if __name__ == "__main__":
    main()
