"""What the reckoning under ``counts/kernels`` is held to in the tests: the
shapes that reach the program's kernel entry points while a call runs,
recorded whatever the device (on the CPU the entry points run their plain
versions), and the comparison of the two."""

from __future__ import annotations

import contextlib
import importlib
import sys
from types import SimpleNamespace

from benchmark import harness
from benchmark.counts import kernels
from benchmark.counts.peaks import least_seconds


# "module:function" -> a function of the entry's arguments giving the
# (kernel, ``count`` arguments) pairs of the launches that one call makes
ENTRIES = {
    "mage_tpu_torch.ops.axial_attention:axial_slot_attention":
        lambda q, k, v, n_head, **_: [("axial", (*q.shape, n_head, q.element_size()))],
    "mage_tpu_torch.ops.cached_attention:cached_slot_attention":
        lambda q, ck, cv, pos, n_head, **_: [
            ("cached", (q.shape[0], ck.shape[0], q.shape[1], int(pos), q.element_size()))],
    "mage_tpu_torch.ops.gn_conv:gn_silu_conv3x3":
        lambda x, gamma, beta, weight, bias, **_: [
            ("gn_conv", (*x.shape, weight.shape[0], x.element_size())),
            ("gn_stats", (*x.shape, x.element_size()))],
    "mage_tpu_torch.ops.vq:nearest_codebook_indices":
        lambda z, cb, **_: [("vq", (z.numel() // z.shape[-1], *cb.shape, z.element_size(), False))],
    "mage_tpu_torch.ops.vq:nearest_with_codes":
        lambda z, cb, **_: [("vq", (z.numel() // z.shape[-1], *cb.shape, z.element_size(), True))],
    "mage_tpu_torch.ops.vq_tail:vq_decode_tail":
        lambda h, x, w7, b7, w8, b8, **_: [
            ("vq_decode_tail", (*h.shape, w7.shape[0], w8.shape[0], h.element_size()))],
}


@contextlib.contextmanager
def recording():
    """Every reference to an entry point in the program's loaded modules
    replaced, while the block runs, by one that appends its launches'
    (kernel, shape) pairs to the list it yields."""
    shapes: list = []
    undo = []
    for entry, shape_of in ENTRIES.items():
        module, func = entry.split(":")
        fn = getattr(importlib.import_module(module), func)

        def call(*args, _fn=fn, _shape_of=shape_of, **kwargs):
            shapes.extend(_shape_of(*args, **kwargs))
            return _fn(*args, **kwargs)

        for name, mod in list(sys.modules.items()):
            if name.split(".")[0] != "mage_tpu_torch" or mod is None:
                continue
            for attr, value in list(vars(mod).items()):
                if value is fn:
                    setattr(mod, attr, call)
                    undo.append((mod, attr, fn))
    try:
        yield shapes
    finally:
        for mod, attr, fn in undo:
            setattr(mod, attr, fn)


def held(p: dict, mix: dict, itemsize: int, shapes: list) -> dict:
    """Each kernel's reckoned pieces for one call or step against the
    recorded launches -> {kernel: {"bytes", "ops", "least_s": (reckoned,
    launched)}}, after checking: operations and peaks equal, and bytes
    equal but for chunks. A call that the program splits into k chunks
    launches each piece k times, and each launch reads its weights and
    affine rows again (``count(0, ...)``'s bytes), where the reckoning reads
    them once; the launched bytes exceed the reckoned by (k - 1) / k of the
    launches' weight and affine bytes."""
    out = {}
    for name in kernels.names():
        spec = kernels.load(name)
        reckoned = spec.pieces(p, mix, itemsize)
        launched = [s for k, s in shapes if k == name]
        if not reckoned:
            assert not launched, (name, launched[:3])
            continue
        counted = [spec.count(*s) for s in launched]
        assert len(counted) % len(reckoned) == 0, (name, len(counted), len(reckoned))
        chunks = len(counted) // len(reckoned)
        got = {key: tuple(sum(f(x) for x in xs) for xs in (reckoned, counted))
               for key, f in (("bytes", lambda x: x[0]), ("ops", lambda x: x[1]),
                              ("least_s", lambda x: least_seconds(*x)[0]))}
        fixed = sum(spec.count(0, *s[1:])[0] for s in launched)
        assert got["ops"][0] == got["ops"][1], (name, got)
        assert {x[2] for x in counted} == {x[2] for x in reckoned}, name
        assert (got["bytes"][1] - got["bytes"][0]) * chunks == fixed * (chunks - 1), (name, got)
        out[name] = got
    return out


def _ctx(config_path, mix: dict, device: str, seed: int):
    return SimpleNamespace(config_path=str(config_path), config=harness.read_json(config_path),
                           mix=mix, device=device, seed=seed)


def one_generate(config_path, mix: dict, device: str, seed: int) -> tuple:
    """One call of the ``generate`` driver's program on the first batch of
    its pool, its weights drawn from ``seed`` -> (model.params, the
    pipeline's itemsize, the recorded launches)."""
    import torch

    drv = harness.load_module(harness.HERE / "traffic" / "generate.py")
    ctx = _ctx(config_path, mix, device, seed)
    dtype = getattr(torch, ctx.config["generate_dtype"])
    p = ctx.config["model"]["params"]
    pipe, shapes, _ = drv.build(ctx)
    pipe.load_state_dict(harness.make_weights(shapes, seed, dtype, device))
    entry = drv.make_pool(p, mix, seed, device, dtype)[0]
    gen = torch.Generator(device=device).manual_seed(seed)
    with recording() as launched:
        drv.generate(pipe, entry, gen, mix)
    return p, dtype.itemsize, launched


def one_train_step(config_path, mix: dict, device: str, seed: int) -> tuple:
    """One step of the ``train`` driver's program, as ``one_generate``; the
    pipeline stays in f32, in which its frozen first stage encodes."""
    import torch

    drv = harness.load_module(harness.HERE / "traffic" / "train.py")
    ctx = _ctx(config_path, mix, device, seed)
    p = ctx.config["model"]["params"]
    pipe, _, step, shapes, _ = drv.build(ctx)
    pipe.load_state_dict(harness.make_weights(shapes, seed, torch.float32, device))
    entry = drv.make_pool(p, mix, seed, device, getattr(torch, ctx.config["train_dtype"]))[0]
    hyper = drv.recipe(ctx.config)
    gen = torch.Generator(device=device).manual_seed(seed)
    with recording() as launched:
        step(entry["batch"], hyper["lr"], hyper["beta"], hyper["alpha"], generator=gen,
             posterior_noise=entry["posterior_noise"])
    return p, 4, launched
