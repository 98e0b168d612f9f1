"""The ``generate`` driver: a closed loop of one client with one batch in
flight, each call ``MagePipeline.generate(batch, cached=..., generator=...)``
on a batch of the mix's size, timed by the host clock to a synchronised end.

Inputs, all from the seed: a pool of distinct batches made in set-up (host
numpy first frames (B, 1, H, W, 3) uniform in [-0.5, 0.5], a caption of one
start id, four words in 3..28 and an end id, padded to the configuration's
context length, and a speed uniform in [0, 1), as the JAX bench makes
them), with the prior sample (and MAGE+'s posterior draw) of each drawn on
the device; the window cycles through the pool. The program receives only
these inputs and its weights (``harness.make_weights``).

After the window a sample of the calls it finished, drawn from the seed by
a reservoir as they finish (at least ``check_clips`` clips), is judged
against the float32 reference (``reference.compare``), and with
``ctx.control`` (an operand rounding) the control beside it.
"""

from __future__ import annotations

import gc
import math
import random
import time
import traceback

import numpy as np
import torch

from benchmark import harness
from benchmark.reference.compare import judge
from benchmark.reference.model import Reference


def make_pool(p: dict, mix: dict, seed: int, device, dtype) -> list:
    """The mix's ``pool`` batches of ``batch`` clips each."""
    b, r = mix["batch"], int(p["image_resolution"])
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
        entry = {"batch": {"images": rng.random((b, 1, res, res, 3), dtype=np.float32) - 0.5,
                           "text": text, "speed": rng.random(b, dtype=np.float32)},
                 "video_noise": torch.randn(b, r, r, 64, generator=gen, device=device).to(dtype),
                 "posterior_noise": None}
        if not p["use_cids"]:
            z = int(p["first_stage_config"]["params"]["embed_dim"])
            entry["posterior_noise"] = torch.randn(b, 1, r, r, z, generator=gen,
                                                   device=device).to(dtype)
        pool.append(entry)
    return pool


class Reservoir:
    """A uniform sample of ``k`` items of a stream of unknown length."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen, self.items = k, 0, []
        self.rng = random.Random(seed)

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = item


def build(ctx):
    """The program's pipeline for the cell in the generation dtype, with the
    first-frame latents and the AR core's output of the call under way kept
    in ``served`` -> (pipe, its tensors' shapes by name, served)."""
    from mage_tpu_torch.models.pipeline import build_pipeline

    mix = ctx.mix
    pipe = build_pipeline(ctx.config_path, device=torch.device(ctx.device), seed=0,
                          spatial_attn=mix.get("spatial_attn", "flat"),
                          kv_quant=mix.get("kv_quant"))
    pipe.to(dtype=getattr(torch, ctx.config["generate_dtype"]))
    shapes = {k: tuple(v.shape) for k, v in pipe.state_dict().items()}
    served = {}
    for obj, attr, key in ((pipe, "encode_first_stage", "latents0"),
                           (pipe.core, core_method(mix), "core")):
        inner = getattr(obj, attr)

        def call(*args, _inner=inner, _key=key, **kwargs):
            served[_key] = out = _inner(*args, **kwargs)
            return out

        setattr(obj, attr, call)
    return pipe, shapes, served


def core_method(mix: dict) -> str:
    return "generate_cached" if mix["cached"] else "generate"


def generate(pipe, entry: dict, gen, mix: dict):
    """One call of the program on a pool entry."""
    return pipe.generate(entry["batch"], video_noise=entry["video_noise"],
                         posterior_noise=entry["posterior_noise"], generator=gen,
                         cached=mix["cached"])


def run(ctx) -> dict:
    """One run of the cell described by ``ctx`` (see ``benchmark.run``)."""
    mix, cfg, dev = ctx.mix, ctx.config, torch.device(ctx.device)
    p = cfg["model"]["params"]
    dtype = getattr(torch, cfg["generate_dtype"])
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    pipe, shapes, served = build(ctx)
    pipe.load_state_dict(harness.make_weights(shapes, ctx.seed, dtype, dev))
    pool = make_pool(p, mix, ctx.seed, dev, dtype)
    gen = torch.Generator(device=dev).manual_seed(ctx.seed)
    spans = None
    if ctx.trace:
        spans = harness.Spans()
        spans.wrap(pipe, "encode_first_stage", "encode")
        spans.wrap(pipe.core, core_method(mix), "ar_core")
        spans.wrap(pipe.first_stage, "decode", "decode")

    def call(i):
        return generate(pipe, pool[i % len(pool)], gen, mix)

    for i in range(mix["warmup_calls"]):
        call(i)
    if ctx.trace:  # the profiler's first start takes seconds: pay it in set-up
        warm = harness.Profiled()
        warm.start()
        call(0)
        warm.stop()
        spans.reset()
    sync()
    setup_s = time.time() - ctx.started
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    threads = harness.quiet_host()

    calls_s, finite, failed, attempted, profiling = [], [], 0, 0, False
    reservoir = Reservoir(math.ceil(mix["check_clips"] / mix["batch"]), ctx.seed)
    profiled_calls = mix["profile_calls"] if ctx.trace else 0
    prof = harness.Profiled() if profiled_calls else None
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < ctx.seconds:
        if prof is not None and attempted == 0:
            prof.start()
            profiling = True
        t0 = time.perf_counter()
        try:
            video = call(attempted)
            sync()
        except Exception:  # a failed call counts, and the loop goes on
            traceback.print_exc()
            failed += 1
            attempted += 1
            continue
        calls_s.append(time.perf_counter() - t0)
        finite.append(torch.isfinite(video).all())  # read after the window: no wait here
        reservoir.offer((attempted % len(pool), served["latents0"], served["core"],
                         video[:, 1:]))
        attempted += 1
        if profiling and attempted == profiled_calls:
            prof.stop()
            profiling = False
    window_s = time.perf_counter() - t_start
    if profiling:
        prof.stop()
    harness.restore_host(threads)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    completed = int(torch.stack(finite).sum()) if finite else 0
    failed += len(finite) - completed

    rec = {"kind": "generate", "calls_s": calls_s, "window_s": window_s,
           "attempted": attempted, "failed": failed, "completed": completed,
           "setup_s": setup_s,
           "peak_bytes": peak, "process_peak_bytes": max(peak, setup_peak),
           "items_per_call": mix["batch"] * (int(p["frames_length"]) - 1),
           "batch": mix["batch"], "model": p, "mix": mix,
           "itemsize": dtype.itemsize,
           "profiled_calls": min(profiled_calls, attempted)}
    if ctx.trace:
        rec["spans_ms"] = {k: v[profiled_calls:] for k, v in spans.ms().items()}
        if prof is not None:
            trace_path = harness.OUT / f"trace_{ctx.cell}.json"
            prof.export(trace_path)
            tr = harness.read_trace(trace_path)
            if tr:
                rec["trace"] = {**harness.summarize_trace(tr), "device_events": tr["device"]}
    rec["forbidden"] = harness.forbidden_modules()

    sample = reservoir.items
    del pipe, served, reservoir, call
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    got = check(p, shapes, ctx.seed, dev, dtype, pool, sample, getattr(ctx, "control", None))
    rec["checks"] = got["program"]
    rec["control_checks"] = got.get("control")
    return rec


def sample_tensors(p: dict, pool: list, sample: list, device) -> tuple:
    """The reference's inputs and the program's outputs of the sampled calls."""
    idx = [s[0] for s in sample]
    cat = lambda xs: torch.cat(xs, dim=0)
    inputs = {
        "frames0": cat([torch.from_numpy(pool[i]["batch"]["images"][:, 0]) for i in idx]
                       ).to(device),
        "text": cat([torch.from_numpy(pool[i]["batch"]["text"]) for i in idx]).to(device),
        "speed": cat([torch.from_numpy(pool[i]["batch"]["speed"]) for i in idx]).to(device),
        "video_noise": cat([pool[i]["video_noise"] for i in idx]),
    }
    if not p["use_cids"]:
        inputs["posterior_noise"] = cat([pool[i]["posterior_noise"] for i in idx])
    served = {"latents0": cat([s[1] for s in sample]), "core": cat([s[2] for s in sample]),
              "frames": cat([s[3] for s in sample])}
    return inputs, served


def check(p, shapes, seed, device, dtype, pool, sample, control=None) -> dict:
    """``reference.compare.judge`` over the sampled calls, the reference
    given the same weights as the program (drawn again from the seed) and,
    with ``control`` (an operand rounding), the control beside it."""
    if not sample:
        return {"program": {}}
    inputs, served = sample_tensors(p, pool, sample, device)
    weights = harness.make_weights(shapes, seed, dtype, device)
    low = Reference(weights, p, q=control) if control is not None else None
    try:
        return judge(Reference(weights, p), inputs, served, control=low)
    except (RuntimeError, IndexError):  # outputs of the wrong shape: no number
        traceback.print_exc()
        return {"program": {}}
