"""The numbers that decide a generation cell's ``correct``.

Each compares what the program served with the float32 reference, one
stage at a time, each stage fed the program's own input to it (the
reference follows the served first-frame latents and the served frames, as
a teacher-forced pass does):

- ``encode_gap`` (discrete): the widest gap, over every first-frame token, by
  which the served code's distance lies above the reference's nearest one,
  in units of that token's spread of distances over the codebook.
- ``encode_err`` (continuous): the largest relative L2 error of a clip's
  first-frame latents against the reference's posterior sample with the
  same noise.
- ``core_gap`` (discrete): the widest gap, over every served token, by which
  its reference logit lies below the reference's best, in units of the
  spread of that position's logits.
- ``core_mean_gap`` (discrete): the same gap averaged over every served
  token: where the widest gap is set by the single nearest tie, this mean
  is steady from seed to seed and grows with the precision's error.
- ``core_err`` (continuous): the largest relative L2 error of a served
  frame's latents against the reference's prediction for it.
- ``decode_err``: the largest relative L2 error of a decoded frame against
  the reference's decode of the same served latents.

``judge`` gives these for the program's outputs and, with ``control`` (the
reference computed in a lower precision), for the outputs the control puts
in their place at the same positions.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from benchmark.reference.model import Reference, float32_math


def _rel_err(got: torch.Tensor, want: torch.Tensor, dims: int) -> torch.Tensor:
    """Relative L2 error over the last ``dims`` dimensions."""
    axes = tuple(range(-dims, 0))
    diff = torch.linalg.vector_norm(got.float() - want, dim=axes)
    return diff / torch.linalg.vector_norm(want, dim=axes).clamp(min=1e-30)


def _gap(scores: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """(best score - chosen score) / spread of the scores, per position."""
    best = scores.amax(-1)
    got = scores.gather(-1, chosen.long().unsqueeze(-1)).squeeze(-1)
    return (best - got) / scores.std(-1).clamp(min=1e-30)


def _stages(ref: Reference, inputs: Mapping[str, torch.Tensor],
            served: Mapping[str, torch.Tensor]) -> dict:
    """The reference's view of one block of clips: scores or values of each
    stage, given the served inputs to it."""
    first = served["latents0"]
    core = served["core"]
    out = {}
    if ref.use_cids:
        out["encode"] = -ref.vq_distances(ref.vq_latents(inputs["frames0"]))
    else:
        out["encode"] = ref.kl_sample(inputs["frames0"], inputs["posterior_noise"][:, 0])
    fed = torch.cat([first[:, :1], core[:, :-1]], dim=1)  # frames 0..L-2
    stem = ref.stem(ref.embed(fed))
    anchor = ref.prepare(stem[:, 0], inputs["text"], inputs["speed"], inputs["video_noise"])
    trunk = ref.trunk(anchor, stem)
    out["core"] = ref.logits(trunk) if ref.use_cids else ref.causal_head(trunk)
    out["decode"] = (ref.vq_decode if ref.use_cids else ref.kl_decode)(core.flatten(0, 1))
    return out


def _numbers(ref_out: dict, cand: dict, discrete: bool) -> dict:
    if discrete:
        core = _gap(ref_out["core"], cand["core"])
        return {"encode_gap": _gap(ref_out["encode"], cand["latents0"]).amax(),
                "core_gap": core.amax(), "core_mean_gap": core.mean(),
                "decode_err": _rel_err(cand["decode"], ref_out["decode"], 3).amax()}
    return {"encode_err": _rel_err(cand["latents0"], ref_out["encode"], 3).amax(),
            "core_err": _rel_err(cand["core"], ref_out["core"], 3).amax(),
            "decode_err": _rel_err(cand["decode"], ref_out["decode"], 3).amax()}


def judge(ref: Reference, inputs: Mapping[str, torch.Tensor],
          served: Mapping[str, torch.Tensor], control: Optional[Reference] = None,
          block: int = 8) -> dict:
    """-> {"program": numbers, "control": numbers or absent}, each the worst
    over every clip (the mean gap: the mean over every served token).
    ``inputs``: frames0 (N, H, W, 3), text, speed, video_noise,
    posterior_noise (continuous only); ``served``: latents0
    (N, 1, h, w[, z]), core (N, L-1, h, w[, z]) and frames (N, L-1, H, W, 3)
    as the program produced them. Runs in blocks of ``block`` clips."""
    worst: dict = {}
    n = served["core"].shape[0]
    n_frames = served["frames"].shape[0] * served["frames"].shape[1]
    with torch.no_grad(), float32_math():
        for s in range(0, n, block):
            inp = {k: v[s:s + block] for k, v in inputs.items()}
            srv = {k: v[s:s + block] for k, v in served.items()}
            want = _stages(ref, inp, srv)
            frames = srv["frames"].flatten(0, 1)
            cands = {"program": {"latents0": srv["latents0"][:, 0], "core": srv["core"],
                                 "decode": frames}}
            if control is not None:
                low = _stages(control, inp, srv)
                if ref.use_cids:
                    cands["control"] = {"latents0": low["encode"].argmax(-1),
                                        "core": low["core"].argmax(-1), "decode": low["decode"]}
                else:
                    cands["control"] = {"latents0": low["encode"], "core": low["core"],
                                        "decode": low["decode"]}
                del low
            for side, cand in cands.items():
                for k, v in _numbers(want, cand, ref.use_cids).items():
                    got = worst.setdefault(side, {})
                    if k.endswith("mean_gap"):  # a mean over the blocks' positions
                        got[k] = got.get(k, 0.0) + float(v) * len(frames) / n_frames
                    else:
                        got[k] = max(got.get(k, 0.0), float(v))
            del want
    return worst
