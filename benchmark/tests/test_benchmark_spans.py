"""The eight readers of the program's spans against a synthetic ring: the
calls and steps they pick, what each computes, and nothing read from a
program that has no tracer or a cell of the other kind; a tracer that
fails to import raises."""

import itertools
import sys

import pytest

from benchmark import harness, spans

READERS = ("ar_issue_ms", "slot_issue_ms", "inputs_wait_ms", "op_host_us",
           "cast_ms", "forward_ms", "backward_ms", "adam_ms")


def reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py")


class Ring:
    """Span records as the tracer gives them, children before their root."""

    def __init__(self):
        self.items, self.ids = [], itertools.count(1)

    def tree(self, root, children, device=None):
        """``children``: (name, host_ms, launches, launch_ns, device_ms,
        parent index or None for the root) tuples."""
        rid = next(self.ids)
        made = []
        for name, host_ms, launches, launch_ns, dev, parent in children:
            made.append({"name": name, "attrs": {}, "id": next(self.ids),
                         "parent": rid if parent is None else made[parent]["id"],
                         "root": rid, "start_ns": 0, "end_ns": int(host_ms * 1e6),
                         "host_ms": host_ms, "launches": launches, "launch_ns": launch_ns,
                         "device_ms": dev})
        self.items += made + [{"name": root, "attrs": {}, "id": rid, "parent": None,
                               "root": rid, "start_ns": 0, "end_ns": 0, "host_ms": 0.0,
                               "launches": {}, "launch_ns": 0, "device_ms": device}]


def generate_call(ring, scale, slots=3):
    kids = [("mage.encode", 1.0 * scale, {"vq": 1}, 40_000, None, None),
            ("mage.inputs", 0.2 * scale, {}, 0, None, None),
            ("mage.ar_core", 10.0 * scale, {}, 0, None, None)]
    kids += [("mage.slot", 2.0 * scale, {"axial": 4, "cached": 2}, 6 * 20_000, None, 2)
             for _ in range(slots)]
    kids.append(("mage.decode", 5.0 * scale, {}, 0, None, None))
    ring.tree("mage.generate", kids)


def train_step(ring, scale, device=True):
    d = (lambda ms: ms * scale) if device else (lambda ms: None)
    ring.tree("mage.train_step", [
        ("mage.cast", 0.5, {}, 0, d(1.0), None),
        ("mage.forward", 3.0, {"vq": 1}, 50_000, d(40.0), None),
        ("mage.encode", 1.0, {"vq": 1}, 50_000, d(30.0), 1),
        ("mage.backward", 2.0, {}, 0, d(20.0), None),
        ("mage.adam", 1.0, {}, 0, d(4.0), None)], device=d(65.0))


@pytest.fixture
def ring(monkeypatch):
    r = Ring()
    monkeypatch.setattr(spans, "program_spans", lambda: r.items)
    return r


def gen_rec(attempted, profiled):
    return {"kind": "generate", "attempted": attempted, "profiled_calls": profiled}


def train_rec(profiled):
    return {"kind": "train", "attempted": 12, "profiled_steps": profiled}


def test_generation_readers_take_the_last_unprofiled_calls(ring):
    generate_call(ring, 100.0)  # set-up: not the window's
    for scale in (1.0, 1.0, 2.0, 4.0):  # two profiled calls, then two unprofiled
        generate_call(ring, scale)
    train_step(ring, 1.0)  # another kind of root between: ignored
    rec = gen_rec(attempted=4, profiled=2)
    assert reader("ar_issue_ms").read(rec) == pytest.approx(30.0)
    assert reader("inputs_wait_ms").read(rec) == pytest.approx(0.6)
    assert reader("slot_issue_ms").read(rec) == pytest.approx(6.0)
    # per call: 1 vq launch at 40 us, 3 slots of 6 launches at 120 us each
    assert reader("op_host_us").read(rec) == pytest.approx((40 + 3 * 120) / 19)
    for name in ("cast_ms", "forward_ms", "backward_ms", "adam_ms"):
        assert reader(name).read(rec) is None


def test_training_readers_take_the_last_steps_with_device_times(ring):
    train_step(ring, 100.0)  # set-up: not the window's
    for _ in range(2):  # the window's profiled steps, slowed by the profiler
        train_step(ring, 50.0)
    for scale in (1.0, 3.0):  # the window's unprofiled steps
        train_step(ring, scale)
    rec = train_rec(profiled=2)
    rec["attempted"] = 4
    assert reader("cast_ms").read(rec) == pytest.approx(2.0)
    assert reader("forward_ms").read(rec) == pytest.approx(20.0)  # less the encode
    assert reader("backward_ms").read(rec) == pytest.approx(40.0)
    assert reader("adam_ms").read(rec) == pytest.approx(8.0)
    train_step(ring, 1.0, device=False)  # a step without device times is skipped
    assert reader("adam_ms").read(rec) == pytest.approx(8.0)
    train_step(ring, 1.0)
    train_step(ring, 40.0)  # a stalled step does not move the median
    rec["attempted"] = 5
    assert reader("cast_ms").read(rec) == pytest.approx(3.0)
    assert reader("forward_ms").read(rec) == pytest.approx(30.0)
    for name in ("ar_issue_ms", "slot_issue_ms", "inputs_wait_ms", "op_host_us"):
        assert reader(name).read(rec) is None


def test_the_phases_cover_the_step(ring):
    train_step(ring, 1.0)
    (tree,) = spans.step_trees({"kind": "train", "attempted": 2, "profiled_steps": 1})
    root = [s for s in tree if s["parent"] is None][0]
    phases = sum(s["device_ms"] for s in tree if s["parent"] == root["id"])
    assert phases == pytest.approx(root["device_ms"])


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read_gives_none(ring, name):
    rec = gen_rec(3, 3) if name in READERS[:4] else train_rec(12)
    generate_call(ring, 1.0)
    train_step(ring, 1.0)
    assert reader(name).read(rec) is None  # no unprofiled call or step
    ring.items.clear()
    rec = gen_rec(3, 1) if name in READERS[:4] else train_rec(2)
    assert reader(name).read(rec) is None  # an empty ring


def test_a_program_without_the_tracer_gives_nothing(monkeypatch):
    import mage_tpu_torch.utils

    monkeypatch.delattr(mage_tpu_torch.utils, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "mage_tpu_torch.utils.trace", None)
    assert spans.program_spans() is None
    for name in READERS:
        kind = gen_rec(4, 1) if name in READERS[:4] else train_rec(2)
        assert reader(name).read(kind) is None


@pytest.mark.parametrize("error", [ModuleNotFoundError("No module named 'numpy'", name="numpy"),
                                   ImportError("cannot import name 'x'")])
def test_a_tracer_that_fails_to_import_raises(monkeypatch, error):
    def fail(name):
        raise error

    monkeypatch.setattr(spans.importlib, "import_module", fail)
    with pytest.raises(ImportError):
        spans.program_spans()


def test_the_program_tracer_feeds_the_readers():
    from mage_tpu_torch.utils import trace

    trace.clear()
    try:
        for _ in range(2):
            with trace.span("mage.generate"):
                with trace.span("mage.inputs"):
                    pass
                with trace.span("mage.ar_core"):
                    with trace.span("mage.slot", pos=0):
                        pass
        rec = gen_rec(2, 0)
        assert len(spans.call_trees(rec)) == 2
        assert reader("ar_issue_ms").read(rec) >= reader("slot_issue_ms").read(rec) > 0
        assert reader("op_host_us").read(rec) is None  # no kernel launched on the CPU
    finally:
        trace.clear()
