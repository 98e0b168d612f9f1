"""The cached sampler as one CUDA graph a shape (``models/graphs.py``).

On the CPU: which calls of ``MAGECore.generate_cached`` go to a graph (a
greedy call by an eval-mode core of the port's own classes over an
unquantized cache, with the card check stubbed) and that those calls give
the eager loop's output, prior draw included; that every other call, and
every call on the CPU, runs the eager loop; the graphs' bookkeeping (the
first call of a key eager, the second captured, an in-place reload kept, a
moved or replaced parameter dropping every graph, the oldest of too many
dropped); and the launch record of a capture, credited once a replay.

On the card (skipped without one; ``python3 -m pytest --noconftest -q
tests/test_torch_port_graphs.py``), at the benchmark's shapes (batch 32,
L=10, bf16) and a second batch: replays bit-equal to the eager loop for
MAGE's ids and MAGE+'s latents, on both spatial routes, and to the eager
loop with the plain QuickGELU chain in place of its kernel; successive calls
keep their own outputs; an in-place reload moves the output as the eager
loop's; the bytes allocated outside a replay grow by the static buffers
only; the launch counts of a replayed call equal the eager loop's.
"""

import copy
import gc

import numpy as np
import pytest
import torch
from torch import nn

from mage_tpu_torch import _build
from mage_tpu_torch.models import graphs, mage
from mage_tpu_torch.models.layers import MAEncoder, TransformerTextEncoder
from mage_tpu_torch.models.pipeline import init_weights
from mage_tpu_torch.utils import trace

B, L, R, W, K = 2, 4, 4, 32, 16


def _core(use_cids=True, kv_quant=None):
    core = mage.MAGECore(codebook_size=K, frames_length=L, image_resolution=R, vision_width=W,
                         randomness=True, use_cids=use_cids, pre_ln=not use_cids, embed_dim=4,
                         text_width=W, text_layers=1, text_output_dim=W, text_context_length=8,
                         ma_d_model=W, dec_layers=3, dec_out_channels=K if use_cids else 4,
                         kv_quant=kv_quant)
    init_weights(core, torch.Generator().manual_seed(0))
    if not use_cids:  # the head's conv starts at zero: give it values
        with torch.no_grad():
            w = core.generate_model.out[2].weight
            w.copy_(torch.randn(w.shape, generator=torch.Generator().manual_seed(1)) * 0.02)
    return core.eval()


def _eager(core, *args, **kwargs):
    """The cached sampler's eager loop, under ``no_grad`` as
    ``generate_cached`` runs it: what a replay is held to."""
    with torch.no_grad():
        return core._cached_loop(*args, **kwargs)


def _inputs(core, batch=B, seed=0):
    gen = torch.Generator().manual_seed(seed)
    if core.use_cids:
        lat0 = torch.randint(0, K, (batch, 1, R, R), generator=gen, dtype=torch.int32)
    else:
        lat0 = torch.randn(batch, 1, R, R, 4, generator=gen)
    text = torch.zeros(batch, 8, dtype=torch.int64)
    text[:, 0], text[:, 5] = 1, 2
    text[:, 1:5] = torch.randint(3, 29, (batch, 4), generator=gen)
    return lat0, text, torch.rand(batch, generator=gen)


class _Routed:
    """``graphs.call`` stand-in: records each call and runs ``fn`` eagerly."""

    def __init__(self):
        self.calls = []

    def __call__(self, module, fn, inputs, route=None):
        self.calls.append((inputs, route))
        return fn(*inputs)


class _Foreign(TransformerTextEncoder):
    """A config-chosen text encoder from outside the port."""


class _ForeignMA(MAEncoder):
    """A config-chosen motion-anchor encoder from outside the port."""


def _train_mode(core):
    core.train()


def _kv_int8(core):
    core.generate_model.kv_quant = "int8"


def _foreign_text_encoder(core):
    core.text_encoder.__class__ = _Foreign


def _foreign_ma_encoder(core):
    core.ma_encoder.__class__ = _ForeignMA


ROUTING = [  # (case, change to the core, generate_cached's keywords, goes to a graph)
    ("greedy", None, {}, True),
    ("temperature", None, {"temperature": 0.7}, False),
    ("train_mode", _train_mode, {}, False),
    ("kv_int8", _kv_int8, {}, False),
    ("foreign_text_encoder", _foreign_text_encoder, {}, False),
    ("foreign_ma_encoder", _foreign_ma_encoder, {}, False),
]


@pytest.mark.parametrize("use_cids,case,change,kwargs,routed", [
    pytest.param(use_cids, *row, id=f"{'mage' if use_cids else 'mageplus'}-{row[0]}")
    for use_cids in (True, False) for row in ROUTING
    if use_cids or row[0] != "temperature"])  # temperature sampling: the discrete head only
def test_which_calls_replay_a_graph(monkeypatch, use_cids, case, change, kwargs, routed):
    """With the card check stubbed true: only a greedy call by an eval-mode
    core of the port's classes over an unquantized cache goes to a graph,
    with the prior drawn before it as the loop draws it; its output is the
    eager loop's, bit for bit. The module keeps its mode."""
    core = _core(use_cids)
    if change is not None:
        change(core)
    was_training = core.training
    lat0, text, speed = _inputs(core)
    want = _eager(core, lat0, text, speed, generator=torch.Generator().manual_seed(3), **kwargs)
    routed_calls = _Routed()
    monkeypatch.setattr(graphs, "call", routed_calls)
    monkeypatch.setattr(mage, "on_card", lambda t: True)
    got = core.generate_cached(lat0, text, speed, generator=torch.Generator().manual_seed(3),
                               **kwargs)
    assert len(routed_calls.calls) == int(routed)
    assert core.training == was_training
    assert torch.equal(got, want)
    if routed:
        (inputs, route), = routed_calls.calls
        assert inputs[0] is lat0 and inputs[1] is text and inputs[2] is speed
        assert inputs[3].shape == (B, R, R, 64) and inputs[3].dtype == torch.float32
        assert route == ("flat",) * 3


@pytest.mark.parametrize("use_cids", [True, False], ids=["mage", "mageplus"])
def test_the_cpu_runs_the_eager_loop(use_cids):
    """On the CPU no graph is made, and the default call is the loop's."""
    core = _core(use_cids)
    lat0, text, speed = _inputs(core)
    noise = torch.randn(B, R, R, 64, generator=torch.Generator().manual_seed(4))
    want = _eager(core, lat0, text, speed, video_noise=noise)
    for _ in range(3):
        assert torch.equal(core.generate_cached(lat0, text, speed, video_noise=noise), want)
    assert core not in graphs._STATES


class _FakeGraph:
    """``graphs._Graph`` stand-in on the CPU: a capture is counted, and a
    replay runs the function eagerly."""

    made: list = []

    def __init__(self, fn, inputs):
        self.fn, self.replays = fn, 0
        _FakeGraph.made.append(self)

    def replay(self, inputs):
        self.replays += 1
        return self.fn(*inputs)


@pytest.fixture()
def fake_graphs(monkeypatch):
    _FakeGraph.made = []
    monkeypatch.setattr(graphs, "_Graph", _FakeGraph)
    monkeypatch.setattr(mage, "on_card", lambda t: True)
    return _FakeGraph.made


def _reload_in_place(core):
    sd = {k: v + 0.01 if v.is_floating_point() else v for k, v in core.state_dict().items()}
    core.load_state_dict(sd)


def _to_f64(core):
    core.to(torch.float64)


def _replace_a_parameter(core):
    core.speed_embedding = nn.Parameter(core.speed_embedding.detach().clone())


def _append_a_block(core):
    blocks = core.generate_model.blocks
    blocks.append(copy.deepcopy(blocks[1]))


@pytest.mark.parametrize("change,kept", [(_reload_in_place, True), (_to_f64, False),
                                         (_replace_a_parameter, False), (_append_a_block, False)],
                         ids=["reload_in_place", "to_f64", "replaced_parameter",
                              "appended_block"])
def test_a_graph_lives_while_the_storage_does(fake_graphs, change, kept):
    """The first call of a key runs the loop, the second captures, later
    ones replay; an in-place reload keeps the graph, which then reads the
    new weights; a ``.to()``, a replaced parameter or an added submodule
    drops it, and the key starts again from the eager loop."""
    core = _core()
    lat0, text, speed = _inputs(core)
    noise = torch.randn(B, R, R, 64, generator=torch.Generator().manual_seed(4))

    def run():
        return core.generate_cached(lat0, text, speed, video_noise=noise)

    before = run()
    assert fake_graphs == []
    for _ in range(2):
        assert torch.equal(run(), before)
    assert len(fake_graphs) == 1 and fake_graphs[0].replays == 2
    change(core)
    want = _eager(core, lat0, text, speed, video_noise=noise)
    assert torch.equal(run(), want)
    if kept:
        assert len(fake_graphs) == 1 and fake_graphs[0].replays == 3
        return
    assert len(fake_graphs) == 1 and fake_graphs[0].replays == 2  # the loop ran
    assert graphs._STATES[core].graphs == {}
    assert torch.equal(run(), want)
    assert len(fake_graphs) == 2 and fake_graphs[1].replays == 1


def test_each_shape_and_route_has_its_graph_and_the_oldest_goes(fake_graphs):
    """Batch sizes and spatial routes are keys of their own, each first
    run eagerly; past ``MAX_GRAPHS`` the oldest graph is dropped."""
    core = _core()
    keys = [(b, "flat") for b in range(1, graphs.MAX_GRAPHS + 1)] + [(1, "fusedblock")]
    for b, route in keys:
        for block in core.generate_model.blocks:
            block.spatial_attn = route
        lat0, text, speed = _inputs(core, batch=b)
        for _ in range(3):
            core.generate_cached(lat0, text, speed)
    assert len(fake_graphs) == len(keys)
    kept = graphs._STATES[core].graphs
    assert len(kept) == graphs.MAX_GRAPHS
    assert [(k[0][0][0][0], k[1][0]) for k in kept] == keys[1:]


def test_a_capture_keeps_its_launches_out_of_the_counts_until_a_replay():
    """Launches made while a graph captures count nowhere but in the
    capture's record; each ``credit`` adds them once to the totals and to
    the innermost open span, with no host time."""
    @_build.launcher("fake")
    def launch():
        pass

    def fakes():
        return trace.launch_counts().get("fake", 0)

    before = fakes()
    trace.clear()
    with trace.span("outer"):
        with _build.capturing_launches() as captured:
            launch()
            launch()
    assert fakes() == before and trace.records()[-1]["launches"] == {}
    assert captured == {"fake": 2}
    with trace.span("replays"):
        _build.credit(captured)
        _build.credit(captured)
    rec = trace.records()[-1]
    assert fakes() == before + 4 and rec["launches"] == {"fake": 4} and rec["launch_ns"] == 0
    launch()  # outside a capture: counted as before
    assert fakes() == before + 5
    trace.clear()


# ---- on the card --------------------------------------------------------------

CONFIGS = {"mage": "config/mage_caterv1.yaml", "mageplus": "config/mage+_caterv2.yaml"}
CELL_B = 32


@pytest.fixture(scope="module")
def card_pipes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mage_tpu_torch.models.pipeline import build_pipeline

    pipes = {}
    for name, path in CONFIGS.items():
        pipe = build_pipeline(path, 10, device="cuda", seed=0)
        if not pipe.use_cids:
            w = pipe.core.generate_model.out[2].weight
            with torch.no_grad():
                w.copy_(torch.randn(w.shape, generator=torch.Generator().manual_seed(5)) * 0.02)
        pipe.to(dtype=torch.bfloat16)
        pipes[name] = pipe
    return pipes


def _card_inputs(pipe, batch, seed):
    """The benchmark's kind of inputs: encoded noise frames, a four-word
    caption, a speed and a prior draw, on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rng = np.random.default_rng(seed)
    frames = torch.rand(batch, 1, 128, 128, 3, generator=gen, device="cuda") - 0.5
    with torch.no_grad():
        lat0 = pipe.encode_first_stage(frames.to(pipe.first_stage.dtype), generator=gen)
    if lat0.is_floating_point():
        lat0 = lat0.to(pipe.dtype)
    ctx = pipe.core.text_encoder.positions.num_embeddings
    text = np.zeros((batch, ctx), np.int64)
    text[:, 0], text[:, 5] = 1, 2
    text[:, 1:5] = rng.integers(3, 29, size=(batch, 4))
    speed = torch.rand(batch, generator=gen, device="cuda").to(pipe.dtype)
    noise = torch.randn(batch, 16, 16, 64, generator=gen, device="cuda").to(pipe.dtype)
    return lat0, torch.from_numpy(text).cuda(), speed, noise


def _spatial_route(pipe, route):
    for block in pipe.core.generate_model.blocks:
        block.spatial_attn = route


@pytest.mark.parametrize("name,batch,route", [("mage", CELL_B, "flat"), ("mage", 3, "flat"),
                                              ("mageplus", CELL_B, "flat"),
                                              ("mageplus", 3, "flat"),
                                              ("mage", 3, "fusedblock")])
def test_replays_are_bit_equal_to_the_eager_loop(card_pipes, name, batch, route):
    pipe = card_pipes[name]
    _spatial_route(pipe, route)
    try:
        core = pipe.core
        args = _card_inputs(pipe, batch, seed=batch)
        want = _eager(core, *args[:3], video_noise=args[3])
        outs = [core.generate_cached(*args[:3], video_noise=args[3]) for _ in range(4)]
        assert len(graphs._STATES[core].graphs) >= 1
        for out in outs:
            assert out.dtype == want.dtype and torch.equal(out, want)
        # the prior drawn before the replay, from the generator, as the loop draws it
        want = _eager(core, *args[:3], generator=torch.Generator("cuda").manual_seed(9))
        got = core.generate_cached(*args[:3], generator=torch.Generator("cuda").manual_seed(9))
        assert torch.equal(got, want)
    finally:
        _spatial_route(pipe, "flat")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_replays_are_bit_equal_to_the_eager_loop_on_the_plain_quick_gelu(card_pipes, name,
                                                                         monkeypatch):
    """The replay, whose MLPs run the QuickGELU kernel, against the eager loop
    with the three-kernel chain in its place: the same ids and latents, as
    the kernel's forward is bit-equal to the chain."""
    from mage_tpu_torch.models import layers
    from mage_tpu_torch.ops import quick_gelu as qg

    pipe = card_pipes[name]
    core = pipe.core
    args = _card_inputs(pipe, CELL_B, seed=21)
    outs = [core.generate_cached(*args[:3], video_noise=args[3]) for _ in range(3)]
    monkeypatch.setattr(layers, "quick_gelu", qg.quick_gelu_plain)
    launches = trace.launch_counts().get("quick_gelu", 0)
    want = _eager(core, *args[:3], video_noise=args[3])
    assert trace.launch_counts().get("quick_gelu", 0) == launches  # the loop ran the chain
    for out in outs:
        assert torch.equal(out, want)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_successive_calls_keep_their_own_outputs(card_pipes, name):
    pipe = card_pipes[name]
    core = pipe.core
    a, b = _card_inputs(pipe, CELL_B, seed=11), _card_inputs(pipe, CELL_B, seed=12)
    want = [_eager(core, *x[:3], video_noise=x[3]) for x in (a, b)]
    for _ in range(2):  # the key's eager call and its capture
        core.generate_cached(*a[:3], video_noise=a[3])
    got_a = core.generate_cached(*a[:3], video_noise=a[3])
    got_b = core.generate_cached(*b[:3], video_noise=b[3])
    assert torch.equal(got_a, want[0]) and torch.equal(got_b, want[1])
    assert not torch.equal(got_a, got_b)


def test_an_in_place_reload_moves_the_output_as_the_eager_loops(card_pipes):
    pipe = card_pipes["mage"]
    core = pipe.core
    args = _card_inputs(pipe, 5, seed=5)
    for _ in range(3):
        old = core.generate_cached(*args[:3], video_noise=args[3])
    saved = {k: v.clone() for k, v in core.state_dict().items()}
    gen = torch.Generator(device="cuda").manual_seed(6)
    try:
        core.load_state_dict({k: v + 0.05 * torch.randn(v.shape, generator=gen, device="cuda"
                                                        ).to(v.dtype)
                              if v.is_floating_point() else v for k, v in saved.items()})
        want = _eager(core, *args[:3], video_noise=args[3])
        got = core.generate_cached(*args[:3], video_noise=args[3])
        assert len(graphs._STATES[core].graphs) >= 1  # the graph was kept
        assert torch.equal(got, want) and not torch.equal(got, old)
    finally:
        core.load_state_dict(saved)


def _nbytes(t):
    return 0 if t is None else -(-t.numel() * t.element_size() // 512) * 512


@pytest.mark.parametrize("name", list(CONFIGS))
def test_outside_a_replay_only_the_static_buffers_stay_allocated(card_pipes, name):
    """The K/V caches and every intermediate live in the graph's pool:
    capturing adds no more allocated bytes than the static inputs and
    output, and a replay no more than the clone it returns. The pool's
    reserved bytes are printed."""
    pipe = card_pipes[name]
    core = pipe.core
    args = _card_inputs(pipe, 17, seed=17)
    core.generate_cached(*args[:3], video_noise=args[3])  # the key's eager call
    gc.collect()
    torch.cuda.synchronize()
    base, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    out = core.generate_cached(*args[:3], video_noise=args[3])  # capture and replay
    del out
    torch.cuda.synchronize()
    (graph,) = [g for k, g in graphs._STATES[core].graphs.items() if k[0][0][0][0] == 17]
    static = sum(_nbytes(t) for t in graph.inputs) + _nbytes(graph.output)
    captured = torch.cuda.memory_allocated()
    print(f"{name}: allocated +{captured - base} B after capture (static {static} B), "
          f"reserved +{torch.cuda.memory_reserved() - reserved} B")
    assert captured - base <= static
    out = core.generate_cached(*args[:3], video_noise=args[3])
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() - captured == _nbytes(out)


def test_a_replayed_call_counts_the_eager_loops_launches(card_pipes):
    """The launch totals and the spans' launch counts of one call: the eager
    loop's, the capturing call's (its capture counts none, its replay all)
    and a replay's are the same (L=10: 40 axial, 20 cached, 61 QuickGELU:
    six blocks a slot and the MA encoder's)."""
    pipe = card_pipes["mage"]
    core = pipe.core
    args = _card_inputs(pipe, 7, seed=7)
    kernels = ("axial", "cached", "quick_gelu")
    for _ in range(3):  # eager, capture and replay, replay
        before = trace.launch_counts()
        trace.clear()
        with trace.span("probe"):
            core.generate_cached(*args[:3], video_noise=args[3])
        spans = trace.records()
        totals: dict = {}
        for s in spans:
            for k, n in s["launches"].items():
                totals[k] = totals.get(k, 0) + n
        after = trace.launch_counts()
        assert tuple(after.get(k, 0) - before.get(k, 0) for k in kernels) == (40, 20, 61)
        assert totals == {"axial": 40, "cached": 20, "quick_gelu": 61}
    assert spans[-1]["name"] == "probe" and spans[-1]["launches"] == totals  # replayed
    trace.clear()
