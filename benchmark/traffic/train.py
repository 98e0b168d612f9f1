"""The ``train`` driver: stage-2 training steps back to back, each
``make_mage_train_step(pipe, make_mage_optimizer(pipe.core), dtype)(batch,
lr, beta, alpha, generator=..., posterior_noise=...)`` with the
configuration's recipe (its ``train.lr``, ``beta`` and ``alpha``), raw
frames in, so the frozen first stage encodes them inside each step.

Inputs, all from the seed: a pool of distinct batches made on the device
(frames (B, L, H, W, 3) uniform in [-0.5, 0.5], a caption of one start id,
four words in 3..28 and an end id padded to the context length, a speed
uniform in [0, 1), and the posterior's standard-normal draw in the compute
dtype), cycled by the window; dropout draws from torch's generator seeded
from the seed. The program receives only these inputs and its weights
(``harness.make_weights``).

Set-up builds the step once and drives it through its first
``check_steps`` steps on distinct batches, recording what the reference
follows: each step's frozen-encode ids, its dropout masks (forward hooks on
the core's dropout layers), its loss, the first gradient as Adam holds it
and the parameters after the last. The same step then warms up and runs
the window. After the window the reference repeats those steps
(``reference.train``)."""

from __future__ import annotations

import gc
import time
import traceback

import numpy as np
import torch

from benchmark import harness
from benchmark.reference.train import judge_train


def make_pool(p: dict, mix: dict, seed: int, device, dtype) -> list:
    """The mix's ``pool`` batches of ``batch`` clips each."""
    b, r, length = mix["batch"], int(p["image_resolution"]), int(p["frames_length"])
    ctx = int(p["text_encoder_config"]["params"]["context_length"])
    res = int(mix["resolution"])
    gen = torch.Generator(device=device).manual_seed(seed)
    pool = []
    for i in range(mix["pool"]):
        rng = np.random.default_rng([seed, i])
        text = np.zeros((b, ctx), np.int64)
        text[:, 0] = 1
        text[:, 1:5] = rng.integers(3, 29, size=(b, 4))
        text[:, 5] = 2
        pool.append({
            "batch": {"images": torch.rand(b, length, res, res, 3, generator=gen,
                                           device=device) - 0.5,
                      "text": torch.from_numpy(text).to(device),
                      "speed": torch.rand(b, generator=gen, device=device)},
            "posterior_noise": torch.randn(b, r, r, 64, generator=gen,
                                           device=device).to(dtype)})
    return pool


class DropoutMasks:
    """Forward hooks on every dropout layer of ``module`` that drops
    anything: each call's mask (where the output is not zero), by the
    layer's name, while the module trains."""

    def __init__(self, module: torch.nn.Module):
        self.masks: dict = {}
        self.handles = [m.register_forward_hook(self._hook(name))
                        for name, m in module.named_modules()
                        if isinstance(m, torch.nn.Dropout) and m.p > 0]

    def _hook(self, name):
        def hook(mod, args, out):
            if mod.training:
                self.masks.setdefault(name, []).append(out != 0)
        return hook

    def take(self) -> dict:
        masks, self.masks = self.masks, {}
        return masks

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


def build(ctx):
    """The program's pipeline, optimizer and train step for the cell ->
    (pipe, optimizer, step, its tensors' shapes by name, served), where
    ``served`` keeps the frozen encode's output of the step under way."""
    from mage_tpu_torch.models.pipeline import build_pipeline
    from mage_tpu_torch.training.mage_trainer import make_mage_optimizer, make_mage_train_step

    pipe = build_pipeline(ctx.config_path, device=torch.device(ctx.device), seed=0)
    shapes = {k: tuple(v.shape) for k, v in pipe.state_dict().items()}
    served = {}
    inner = pipe.encode_first_stage

    def encode(*args, **kwargs):
        served["ids"] = out = inner(*args, **kwargs)
        return out

    pipe.encode_first_stage = encode
    opt = make_mage_optimizer(pipe.core)
    step = make_mage_train_step(pipe, opt, getattr(torch, ctx.config["train_dtype"]))
    return pipe, opt, step, shapes, served


def recipe(cfg: dict) -> dict:
    p = cfg["model"]["params"]
    return {"lr": float(cfg["train"]["lr"]), "beta": float(p["beta"]),
            "alpha": float(p["alpha"]), "betas": (0.9, 0.98), "eps": 1e-6}


def run(ctx) -> dict:
    """One run of the cell described by ``ctx`` (see ``benchmark.run``)."""
    mix, cfg, dev = ctx.mix, ctx.config, torch.device(ctx.device)
    p = cfg["model"]["params"]
    dtype = getattr(torch, cfg["train_dtype"])
    hyper = recipe(cfg)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    torch.manual_seed(ctx.seed)
    pipe, opt, step, shapes, served = build(ctx)
    pipe.load_state_dict(harness.make_weights(shapes, ctx.seed, torch.float32, dev))
    pool = make_pool(p, mix, ctx.seed, dev, dtype)
    gen = torch.Generator(device=dev).manual_seed(ctx.seed)

    def call(i):
        e = pool[i % len(pool)]
        return step(e["batch"], hyper["lr"], hyper["beta"], hyper["alpha"], generator=gen,
                    posterior_noise=e["posterior_noise"])

    # the steps the reference follows, through the window's own call
    hooks = DropoutMasks(pipe.core)
    checked, losses, grad = [], [], {}
    b1 = opt.param_groups[0]["betas"][0]
    for i in range(mix["check_steps"]):
        terms = call(i)
        losses.append(terms["final_loss"])
        checked.append({"ids": served["ids"], "masks": hooks.take()})
        if i == 0:
            grad = {k: opt.state[v]["exp_avg"] / (1 - b1)
                    for k, v in pipe.core.named_parameters() if v in opt.state}
    after = {k: v.detach().clone() for k, v in pipe.core.named_parameters()}
    hooks.remove()

    spans = None
    if ctx.trace:
        spans = harness.Spans()
        spans.wrap(pipe, "encode_first_stage", "frozen_encode")
    done = mix["check_steps"]
    for _ in range(mix["warmup_steps"]):
        call(done)
        done += 1
    if ctx.trace:  # the profiler's first start takes seconds: pay it in set-up
        warm = harness.Profiled()
        warm.start()
        call(done)
        done += 1
        warm.stop()
        spans.reset()
    sync()
    setup_s = time.time() - ctx.started
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    threads = harness.quiet_host()

    finite, failed, attempted = [], 0, 0
    profiled = mix["profile_steps"] if ctx.trace else 0
    prof = harness.Profiled() if profiled else None
    t_start = t_steady = time.perf_counter()
    while time.perf_counter() - t_start < ctx.seconds:
        if prof is not None and attempted == 0:
            prof.start()
        try:
            terms = call(done + attempted)
            finite.append(torch.isfinite(terms["final_loss"]))  # read after the window
        except Exception:  # a failed step counts, and the loop goes on
            traceback.print_exc()
            failed += 1
        attempted += 1
        if prof is not None and attempted == profiled:
            prof.stop()
            t_steady = time.perf_counter()
    sync()
    window_s = time.perf_counter() - t_start
    steady_s = time.perf_counter() - t_steady
    if prof is not None and attempted < profiled:
        prof.stop()
    harness.restore_host(threads)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    completed = int(torch.stack(finite).sum()) if finite else 0
    failed += len(finite) - completed

    rec = {"kind": "train", "window_s": window_s, "attempted": attempted, "failed": failed,
           "completed": completed, "setup_s": setup_s, "peak_bytes": peak,
           "process_peak_bytes": max(peak, setup_peak), "batch": mix["batch"], "model": p,
           "mix": mix, "itemsize": 4,  # the pipeline's f32, in which the frozen encode runs
           "profiled_steps": min(profiled, attempted), "steady_s": steady_s,
           "steady_steps": max(attempted - profiled, 0)}
    if ctx.trace:
        rec["spans_ms"] = {k: v[profiled:] for k, v in spans.ms().items()}
        if prof is not None:
            trace_path = harness.OUT / f"trace_{ctx.cell}.json"
            prof.export(trace_path)
            tr = harness.read_trace(trace_path)
            if tr:
                rec["trace"] = {**harness.summarize_trace(tr), "device_events": tr["device"]}
    rec["forbidden"] = harness.forbidden_modules()

    steps = [{"frames": pool[i]["batch"]["images"], "text": pool[i]["batch"]["text"],
              "speed": pool[i]["batch"]["speed"],
              "posterior_noise": pool[i]["posterior_noise"], **c}
             for i, c in enumerate(checked)]
    program = {"losses": [float(x) for x in losses], "grad": grad}
    del pipe, opt, step, served, call, spans
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    weights = harness.make_weights(shapes, ctx.seed, torch.float32, dev)
    program["change"] = {k: v - weights[k] for k, v in after.items()}
    del after
    try:
        got = judge_train(weights, p, steps, hyper, program, getattr(ctx, "control", None))
    except (RuntimeError, IndexError, KeyError):  # outputs of the wrong shape: no number
        traceback.print_exc()
        got = {"program": {}}
    rec["checks"] = got["program"]
    rec["control_checks"] = got.get("control")
    return rec
