"""On the card, at each cell's own size and through the run's own path: the
program reads within every limit of its cell and the control (the reference
with fp8 operands in the program's place) above one of them, on three
seeds. Skips without a CUDA device; run it as
``python -m pytest benchmark/tests/test_benchmark_card.py`` on the card."""

import pytest

from benchmark import calibrate, harness

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
