"""The numbers that decide a training cell's ``correct``: the program's
first three steps against the plain reference's, from the same weights,
batches, posterior noise and dropout masks (the masks the program drew,
recorded at its dropout layers; ``MaskFeed``), the reference's core fed the
program's frozen-encode ids as each generation stage is fed the program's
own input.

- ``encode_gap``: the widest gap, over every token of the three steps'
  frames, by which the program's code's distance lies above the
  reference's nearest one, in units of that token's spread of distances.
- ``loss_gap``: the relative gap of the first step's loss, and
  ``loss_gap_steps`` the largest over the steps. (Adam's first updates move
  every element by about the learning rate whatever its gradient's size,
  so the elements whose gradient is round-off move differently on the two
  sides, and the later steps' losses part by that.) Both are read; a
  cell's limits say which numbers are compared.
- ``grad_gap``: the first gradient as the optimizer got it (Adam's first
  moment after one step over 1 - beta1), by the worst leaf: the gap between
  the leaf's norm and the reference's, over the larger of the reference's
  norm of that leaf and of the median leaf.
- ``change_gap``: the same for the parameters' change over the three steps,
  elements whose reference gradient is under a thousandth of the median
  leaf's root mean square left out (Adam moves those by round-off alone).
- ``grad_median_err``: the first gradient's error, the norm of its
  difference from the reference's over the larger of the reference's norm
  of that leaf and of the median leaf, for the median leaf. A gap of norms
  barely sees rounding, which moves a norm only to second order; this
  error sees it to first order, and the median leaf's is steady from seed
  to seed where the worst leaf's swings.

``judge_train`` gives these for the program and, with ``control`` (an
operand rounding of the reference, straight through in the backward
pass), for the reference put in the program's place one precision below
the configuration's in each stage, following its own three steps: stage
2's products in that rounding (fp8 below its bf16), the frozen encode's
in bf16 (below its float32, whose convolutions the program runs with
cuDNN's default TF32)."""

from __future__ import annotations

import statistics
from typing import Mapping, Optional

import torch

from benchmark.reference.compare import _gap
from benchmark.reference.model import FS, Reference, bf16_round, float32_math


class MaskFeed:
    """Dropout masks by site, handed out in the order the site used them."""

    def __init__(self, masks: Mapping[str, list]):
        self.masks = masks
        self.used = dict.fromkeys(masks, 0)

    def next(self, site: str) -> torch.Tensor:
        i = self.used[site]
        self.used[site] = i + 1
        return self.masks[site][i]

    def check_all_used(self) -> None:
        left = {k: len(self.masks[k]) - n for k, n in self.used.items() if n != len(self.masks[k])}
        if left:
            raise RuntimeError(f"dropout masks the reference did not use: {left}")


def straight_through(q):
    """An operand rounding applied in the forward pass only."""
    return lambda x: x + (q(x) - x).detach()


def run_steps(weights: Mapping[str, torch.Tensor], cfg: Mapping, steps: list, hyper: Mapping,
              q=None, q_encode=None) -> dict:
    """The reference's own training steps from ``weights``: the frozen
    encode's distances of each step's frames, each step's loss, the first
    gradient, and the change of every core tensor over the steps (Adam as
    the configuration states it, written out). ``steps``: dicts of frames
    (B, L, H, W, 3), text, speed, posterior_noise, ids (the program's) and
    masks (site -> list). ``q`` rounds the operands of stage 2's products,
    ``q_encode`` those of the frozen encode. -> {"distances": [...], "losses": [...],
    "grad": {name: tensor}, "change": {name: tensor}, "ids": [...] (the
    reference's own nearest codes)}."""
    b1, b2, eps, lr = hyper["betas"][0], hyper["betas"][1], hyper["eps"], hyper["lr"]
    first = {k: v.float() for k, v in weights.items() if k.startswith(FS)}
    start = {k: v.float() for k, v in weights.items() if not k.startswith(FS)}
    params = {k: v.clone().requires_grad_(True) for k, v in start.items()}
    m = {k: torch.zeros_like(v) for k, v in start.items()}
    v2 = {k: torch.zeros_like(v) for k, v in start.items()}
    rounding = straight_through(q) if q is not None else (lambda t: t)
    out = {"distances": [], "ids": [], "losses": [], "grad": None}
    with float32_math():
        for t, step in enumerate(steps, start=1):
            ref = Reference({**first, **params}, cfg, q=rounding)
            with torch.no_grad():
                enc = Reference(first, cfg, q=q_encode or (lambda t: t))
                frames = step["frames"].flatten(0, 1)
                dist = torch.cat([enc.vq_distances(enc.vq_latents(f))
                                  for f in frames.split(16)], dim=0)
                out["distances"].append(dist)
                out["ids"].append(dist.argmin(-1))
            ref.masks = MaskFeed(step["masks"])
            terms = ref.train_terms(step["ids"], step["text"], step["speed"],
                                    step["posterior_noise"], hyper["beta"], hyper["alpha"])
            ref.masks.check_all_used()
            names = list(params)
            grads = torch.autograd.grad(terms["final_loss"], [params[k] for k in names],
                                        allow_unused=True)
            out["losses"].append(float(terms["final_loss"].detach()))
            grads = {k: (g if g is not None else torch.zeros_like(params[k]))
                     for k, g in zip(names, grads)}
            if out["grad"] is None:
                out["grad"] = {k: g.clone() for k, g in grads.items()}
            with torch.no_grad():
                for k, g in grads.items():
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (v2[k] / (1 - b2 ** t)).sqrt_().add_(eps)
                    params[k].addcdiv_(m[k], denom, value=-lr / (1 - b1 ** t))
            del terms, grads, ref
    out["change"] = {k: (params[k].detach() - start[k]) for k in params}
    return out


def _leaf_gaps(got: Mapping, want: Mapping, keep: Optional[Mapping] = None) -> list:
    """Each leaf's gap of norms, over the larger of the reference's norm of
    that leaf and of the median leaf; with ``keep`` (name -> the elements to
    count) over those elements alone."""
    pick = (lambda k, t: t) if keep is None else (lambda k, t: t[keep[k]])
    names = [k for k in want if keep is None or bool(keep[k].any())]
    norms = {k: float(torch.linalg.vector_norm(pick(k, want[k]).float())) for k in names}
    median = statistics.median(norms.values())
    return [abs(float(torch.linalg.vector_norm(pick(k, got[k]).float())) - n)
            / max(n, median, 1e-30) for k, n in norms.items()]


def numbers(cand: dict, ref: dict) -> dict:
    """The numbers of a candidate's readings (``ids``, ``losses``,
    ``grad``, ``change``) against the reference's. The change leaves out
    the elements whose reference gradient is under a thousandth of the
    median leaf's root mean square: a key's bias under softmax has none but
    round-off, and Adam moves it by a step of the learning rate whatever
    the round-off's size."""
    encode = max(float(_gap(-d.reshape(-1, d.shape[-1]), i.reshape(-1)).amax())
                 for d, i in zip(ref["distances"], cand["ids"]))
    losses = [abs(a - b) / abs(b) for a, b in zip(cand["losses"], ref["losses"])]
    rms = [float(torch.linalg.vector_norm(g)) / g.numel() ** 0.5 for g in ref["grad"].values()]
    floor = 1e-3 * statistics.median(rms)
    moved = {k: g.abs() >= floor for k, g in ref["grad"].items()}
    median = statistics.median(float(torch.linalg.vector_norm(g)) for g in ref["grad"].values())
    grad_err = [float(torch.linalg.vector_norm(cand["grad"][k].float() - g))
                / max(float(torch.linalg.vector_norm(g)), median, 1e-30)
                for k, g in ref["grad"].items()]
    return {"encode_gap": encode, "loss_gap": losses[0], "loss_gap_steps": max(losses),
            "grad_gap": max(_leaf_gaps(cand["grad"], ref["grad"])),
            "grad_median_err": statistics.median(grad_err),
            "change_gap": max(_leaf_gaps(cand["change"], ref["change"], keep=moved))}


def judge_train(weights: Mapping[str, torch.Tensor], cfg: Mapping, steps: list,
                hyper: Mapping, served: dict, control: Optional[object] = None) -> dict:
    """-> {"program": numbers, "control": numbers or absent}. ``served``:
    the program's ``losses`` (one a step), ``grad`` and ``change`` (name ->
    tensor; a leaf it gave no gradient is absent) and each step's ``ids``."""
    ref = run_steps(weights, cfg, steps, hyper)
    zeros = {k: torch.zeros_like(v) for k, v in ref["grad"].items()}
    prog = {"ids": [s["ids"] for s in steps], "losses": served["losses"],
            "grad": {**zeros, **served["grad"]}, "change": {**zeros, **served["change"]}}
    got = {"program": numbers(prog, ref)}
    if control is not None:
        low = run_steps(weights, cfg, steps, hyper, q=control, q_encode=bf16_round)
        got["control"] = numbers(low, ref)
    return got
