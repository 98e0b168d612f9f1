"""``utils.trace``: spans nest with parents and root ids; the always-on path
keeps host stamps and launch counts and records no events or ranges; under
``torch.profiler`` each span's stamps match its range in the exported
chrome trace; a timed span (the train step) records device times always;
``generate`` and the train step record their stages; and the launch
counter (``_build.launcher``) charges the innermost open span and the
process-wide totals, which count a launch on any thread."""

import json
import threading

import numpy as np
import pytest
import torch

from mage_tpu_torch import _build
from mage_tpu_torch.models.pipeline import MagePipeline
from mage_tpu_torch.training.mage_trainer import make_mage_optimizer, make_mage_train_step
from mage_tpu_torch.utils import profiling, trace

B, FRAMES, RES, LAT, K = 2, 4, 32, 4, 16


@pytest.fixture(autouse=True)
def empty_ring():
    trace.clear()
    yield
    trace.clear()


def _config():
    return dict(
        first_stage_config={"target": "mage_tpu.models.vqvae.VectorQuantizedVAE",
                            "params": {"input_dim": 3, "down_ratio": 8, "dim": 8, "K": K}},
        text_encoder_config={"target": "mage_tpu.models.layers.TransformerTextEncoder",
                             "params": {"vocab_size": 30, "context_length": 8,
                                        "transformer_width": 32, "transformer_layers": 1,
                                        "output_dim": 32, "padding_idx": 0, "dropout": 0.1}},
        ma_config={"target": "mage_tpu.models.layers.MAEncoder",
                   "params": {"layers": 1, "d_model": 32}},
        generate_decoder_config={"target": "mage_tpu.models.mage.FlatAxialDecoder",
                                 "params": {"layers": 3, "model_channels": 32,
                                            "in_channels": 32, "out_channels": K,
                                            "frames_length": FRAMES}},
        codebook_size=K, frames_length=FRAMES, image_resolution=LAT, vision_width=32,
        dropout=0.1, use_cids=True, randomness=True, beta=0.00025, alpha=0.001)


@pytest.fixture(scope="module")
def pipe():
    return MagePipeline(**_config(), device="cpu")


def _batch(frames):
    rng = np.random.RandomState(0)
    text = np.zeros((B, 8), np.int64)
    text[:, 0] = 1
    text[:, 1:5] = rng.randint(3, 29, size=(B, 4))
    text[:, 5] = 2
    return {"images": rng.rand(B, frames, RES, RES, 3).astype(np.float32) - 0.5,
            "text": text, "speed": rng.rand(B).astype(np.float32)}


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r["name"], []).append(r)
    return out


def _fake_launcher(kernel, inner=None):
    @_build.launcher(kernel)
    def launch(x):
        return x if inner is None else inner(x)
    return launch


def test_spans_nest_with_parents_and_root_ids():
    with trace.span("a") as a:
        with trace.span("b", pos=3) as b:
            with trace.span("c") as c:
                pass
        with trace.span("d") as d:
            pass
    with trace.span("e") as e:
        pass
    recs = {r["name"]: r for r in trace.records()}
    assert [r["name"] for r in trace.records()] == ["c", "b", "d", "a", "e"]
    assert recs["a"]["parent"] is None and recs["a"]["root"] == a.id
    assert recs["b"]["parent"] == a.id and recs["b"]["attrs"] == {"pos": 3}
    assert recs["c"]["parent"] == b.id and recs["d"]["parent"] == a.id
    assert {recs[n]["root"] for n in "abcd"} == {a.id}
    assert recs["e"]["root"] == e.id != a.id and len({a.id, b.id, c.id, d.id, e.id}) == 5
    assert recs["a"]["start_ns"] <= recs["b"]["start_ns"] <= recs["c"]["start_ns"]
    assert recs["c"]["end_ns"] <= recs["b"]["end_ns"] <= recs["d"]["start_ns"]
    assert recs["d"]["end_ns"] <= recs["a"]["end_ns"] <= recs["e"]["start_ns"]
    assert trace.CAPACITY >= 65536
    trace.clear()
    assert trace.records() == []


def test_always_on_path_keeps_stamps_and_counts_but_no_events_or_ranges(monkeypatch):
    opened = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name) or real(name))
    launch = _fake_launcher("k")
    with trace.span("outer"):
        launch(1)
        launch(2)
    (rec,) = trace.records()
    assert opened == [] and rec["device_ms"] is None
    assert rec["launches"] == {"k": 2} and rec["launch_ns"] > 0
    assert rec["end_ns"] > rec["start_ns"] and rec["host_ms"] > 0
    with trace.recording():  # on demand: the range, and no events without a card
        with trace.span("forced"):
            pass
    assert opened == ["forced"] and trace.records()[-1]["device_ms"] is None


class _FakeEvent:
    """A CUDA event's interface on the CPU: elapsed milliseconds are 2.5."""

    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _FakeEvent.made += 1

    def record(self):
        pass

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return 2.5


def test_a_timed_span_and_the_spans_under_it_time_the_device_always(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: opened.append(name))
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    _FakeEvent.made = 0
    with trace.span("plain"):
        pass
    with trace.span("step", timed=True):
        with trace.span("phase"):
            with trace.span("inner"):
                pass
    recs = {r["name"]: r for r in trace.records()}
    assert _FakeEvent.made == 6 and opened == []  # events, and no profiler ranges
    assert recs["plain"]["device_ms"] is None and not recs["plain"]["timed"]
    for name in ("step", "phase", "inner"):
        assert recs[name]["timed"] and recs[name]["device_ms"] == 2.5, name
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with trace.span("captured", timed=True):
        pass
    assert trace.records()[-1]["device_ms"] is None and _FakeEvent.made == 6


def test_a_span_in_cuda_graph_capture_keeps_host_stamps_only(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: opened.append(name))
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with trace.recording(), trace.span("captured"):
        pass
    (rec,) = trace.records()
    assert opened == [] and rec["device_ms"] is None and rec["end_ns"] >= rec["start_ns"]


def test_spans_share_the_clock_of_the_profilers_chrome_trace(tmp_path):
    with profiling.profile_trace(str(tmp_path)):
        with trace.span("clock.outer"):
            torch.randn(64, 64) @ torch.randn(64, 64)
            with trace.span("clock.inner"):
                torch.randn(64, 64).sum()
    doc = json.loads((tmp_path / profiling.TRACE_FILE).read_text())
    base = int(doc.get("baseTimeNanoseconds", 0))
    ranges = {e["name"]: e for e in doc["traceEvents"]
              if e.get("ph") == "X" and e.get("name", "").startswith("clock.")}
    recs = {r["name"]: r for r in trace.records()}
    assert set(ranges) == set(recs) == {"clock.outer", "clock.inner"}
    for name, r in recs.items():
        start = float(ranges[name]["ts"]) * 1e3 + base
        end = start + float(ranges[name]["dur"]) * 1e3
        assert abs(r["start_ns"] - start) < 1e6 and abs(r["end_ns"] - end) < 1e6, name


def test_cached_generate_records_its_stages_and_every_slot(pipe):
    pipe.generate(_batch(1), generator=torch.Generator().manual_seed(0), cached=True)
    recs = trace.records()
    (root,) = [r for r in recs if r["parent"] is None]
    assert root["name"] == "mage.generate" and all(r["root"] == root["id"] for r in recs)
    names = _by_name(recs)
    for stage in ("mage.encode", "mage.inputs", "mage.ar_core", "mage.decode"):
        assert len(names[stage]) == 1 and names[stage][0]["parent"] == root["id"], stage
    slots = names["mage.slot"]
    assert [s["attrs"]["pos"] for s in slots] == list(range(FRAMES))
    core = names["mage.ar_core"][0]
    assert all(s["parent"] == core["id"] for s in slots)
    assert sorted(names) == sorted(["mage.generate", "mage.encode", "mage.inputs",
                                    "mage.ar_core", "mage.slot", "mage.decode"])
    assert not any(r["timed"] for r in recs)


def test_train_step_records_its_phases_under_one_root(pipe):
    step = make_mage_train_step(pipe, make_mage_optimizer(pipe.core), torch.bfloat16)
    state = {k: v.detach().clone() for k, v in pipe.core.state_dict().items()}
    try:
        with torch.random.fork_rng():  # dropout draws from the global generator
            step(_batch(FRAMES), 1e-4, 0.00025, 0.001,
                 generator=torch.Generator().manual_seed(0))
    finally:
        pipe.core.load_state_dict(state)
    recs = trace.records()
    (root,) = [r for r in recs if r["parent"] is None]
    assert root["name"] == "mage.train_step" and all(r["root"] == root["id"] for r in recs)
    assert all(r["timed"] for r in recs)  # device times on every step, where a card runs it
    names = _by_name(recs)
    phases = ["mage.cast", "mage.forward", "mage.backward", "mage.adam"]
    for phase in phases:
        assert len(names[phase]) == 1 and names[phase][0]["parent"] == root["id"], phase
    assert [r["name"] for r in recs if r["parent"] == root["id"]] == phases
    (encode,) = names["mage.encode"]
    assert encode["parent"] == names["mage.forward"][0]["id"]


def test_launches_go_to_the_innermost_open_span():
    stats = _fake_launcher("inner")
    conv = _fake_launcher("outer", inner=stats)  # a launcher that calls another
    conv(0)  # no span open: counted nowhere
    with trace.span("a"):
        conv(1)
        with trace.span("b"):
            stats(2)
            stats(3)
    recs = {r["name"]: r for r in trace.records()}
    assert set(recs) == {"a", "b"}
    assert recs["a"]["launches"] == {"inner": 1, "outer": 1}
    assert recs["b"]["launches"] == {"inner": 2}
    assert recs["a"]["launch_ns"] > 0 and recs["b"]["launch_ns"] > 0


def test_a_nested_launcher_counts_its_launch_in_its_callers_time():
    stats = _fake_launcher("inner")
    with trace.span("only_inner"):
        stats(0)
    conv = _fake_launcher("outer", inner=lambda x: [stats(x) for _ in range(3)])
    with trace.span("both"):
        conv(0)
    recs = {r["name"]: r for r in trace.records()}
    assert recs["both"]["launches"] == {"outer": 1, "inner": 3}
    assert recs["only_inner"]["launch_ns"] > 0


def test_a_launcher_that_raises_counts_nothing():
    def bad(x):
        raise ValueError("refused")

    launch = _fake_launcher("bad", inner=bad)
    with trace.span("s"):
        with pytest.raises(ValueError, match="refused"):
            launch(0)
        _fake_launcher("ok")(0)
    (rec,) = trace.records()
    assert rec["launches"] == {"ok": 1}


def test_a_launch_on_another_thread_outside_every_span_counts_in_the_totals_only():
    """As autograd's backward thread launches: the totals count it, and no
    span does, not even one open on the thread that started the work."""
    launch = _fake_launcher("elsewhere")
    before = trace.launch_counts().get("elsewhere", 0)
    with trace.span("caller"):
        worker = threading.Thread(target=lambda: [launch(i) for i in range(3)])
        worker.start()
        worker.join()
    (rec,) = trace.records()
    assert rec["launches"] == {} and rec["launch_ns"] == 0
    assert trace.launch_counts()["elsewhere"] == before + 3
    counts = trace.launch_counts()
    counts["elsewhere"] = 0  # a copy: the totals are not changed through it
    assert trace.launch_counts()["elsewhere"] == before + 3


def test_cost_analysis_lists_the_kernel_launches_it_cannot_count():
    launch = _fake_launcher("gn_conv")
    x = torch.randn(4, 8)
    lin = torch.nn.Linear(8, 3)
    out = profiling.cost_analysis(lambda t: launch(lin(t)), x)
    assert out == {"flops": 2 * 4 * 8 * 3, "kernel_launches": {"gn_conv": 1}}
    assert profiling.cost_analysis(lin, x) == {"flops": 2 * 4 * 8 * 3}

    def nested(t):
        with trace.span("mage.slot"):
            launch(t)
            launch(t)
        return launch(lin(t))

    with trace.span("outer"):  # launches before and after the call are not its own
        launch(x)
        out = profiling.cost_analysis(nested, x)
        launch(x)
    assert out == {"flops": 2 * 4 * 8 * 3, "kernel_launches": {"gn_conv": 3}}
