"""On the card, at each cell's own size and through the run's own path: the
program reads within every limit of its cell and the control (the reference
with fp8 operands in the program's place) above one of them, on three
seeds; the kernels' work reckoned from each cell's configuration equals
what one call or step launches; and a CUDA graph's replay of the AR core's
kernels reads the same roofline as their eager launches. Skips without a
CUDA device; run it as
``python -m pytest benchmark/tests/test_benchmark_card.py`` on the card."""

import json

import pytest

from benchmark import calibrate, harness, readers
from benchmark.tests import launches

SEEDS = (2718281828, 3141592653, 1618033988)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("cell", [c["name"] for c in harness.manifest()["workloads"]])
def test_control_fails_and_program_passes_at_the_cells_size(card, cell):
    from benchmark.reference.model import fp8_round

    spec = {c["name"]: c for c in harness.manifest()["workloads"]}[cell]
    limits = harness.read_json(harness.HERE / "workloads" / f"{cell}.json")["limits"]
    for row in calibrate.readings(spec, list(SEEDS), 5.0, "cuda", fp8_round):
        assert row["correct"] and all(row["program"][k] <= v for k, v in limits.items()), row
        assert any(row["control"][k] > v for k, v in limits.items()), row


@pytest.mark.parametrize("cell", [c["name"] for c in harness.manifest()["workloads"]])
def test_reckoned_work_equals_the_launches_at_the_cells_size(card, cell):
    """Operations equal; bytes equal but for the weight and affine bytes
    that chunked launches read again (MAGE+'s three chunks of 96 frames
    read gn_conv's 86 MB of weights twice more, 0.6% of its bytes); the
    least time within 0.1%."""
    spec = {c["name"]: c for c in harness.manifest()["workloads"]}[cell]
    config = harness.HERE / "configs" / f"{spec['config']}.json"
    mix = harness.read_json(harness.HERE / "traffic" / f"{spec['traffic']}.json")
    one = launches.one_generate if mix["driver"] == "generate" else launches.one_train_step
    p, itemsize, shapes = one(config, mix, "cuda", SEEDS[0])
    got = launches.held(p, mix, itemsize, shapes)
    print(json.dumps({cell: got}))
    assert got
    for name, x in got.items():
        assert x["least_s"][0] == pytest.approx(x["least_s"][1], rel=1e-3), (name, x)


def test_a_graph_replay_reads_the_roofline_of_eager_launches(card):
    """One MAGE generate's axial and cached launches (``mage_gen_b32``'s
    shapes, in slot order), three times eagerly and three times replayed
    from one ``torch.cuda.CUDAGraph``, each under the profiler: every
    replayed launch shows as a device event under its kernel's trace names,
    and ``readers.roofline_pct`` reads the replay within 10% of the eager
    launches."""
    import torch

    from benchmark.counts import kernels
    from mage_tpu_torch.ops.axial_attention import axial_slot_attention
    from mage_tpu_torch.ops.cached_attention import cached_slot_attention

    p = harness.read_json(harness.HERE / "configs" / "mage_caterv1.json")["model"]["params"]
    mix = harness.read_json(harness.HERE / "traffic" / "gen_b32.json")
    length, r, c, layers, _ = kernels.decoder(p)
    b, heads, dt = mix["batch"], c // 32, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEEDS[0])

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dt)

    q, k, v = (randn(b * r, r, c) for _ in range(3))
    qn, ck, cv = randn(b * r * r, c), randn(length, b * r * r, c), randn(length, b * r * r, c)

    def one_call():
        for pos in range(length):
            for i in range(layers):
                if i % 3 == 0:
                    cached_slot_attention(qn, ck, cv, pos, heads)
                else:
                    axial_slot_attention(q, k, v, heads)

    one_call()  # builds the kernels and warms every shape
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        one_call()
    reps, read = 3, {}
    for mode, run in (("eager", one_call), ("graph", graph.replay)):
        prof = harness.Profiled()
        prof.start()
        for _ in range(reps):
            run()
        prof.stop()
        path = harness.OUT / f"test_graph_replay_{mode}.json"
        prof.export(path)
        tr = harness.read_trace(path)
        rec = {"kind": "generate", "model": p, "mix": mix, "itemsize": 2,
               "profiled_calls": reps, "trace": {"device_events": tr["device"]}}
        for name in ("axial", "cached"):
            spec = kernels.load(name)
            events = [e for e in tr["device"]
                      if harness.short_name(e[0]).split("::")[-1] in spec.TRACE_NAMES]
            assert len(events) == reps * len(spec.pieces(p, mix, 2)), (mode, name, len(events))
            read[mode, name] = readers.roofline_pct(rec, name)
    print(json.dumps({f"{m}.{n}": v for (m, n), v in read.items()}))
    for name in ("axial", "cached"):
        assert read["graph", name] == pytest.approx(read["eager", name], rel=0.1), read
