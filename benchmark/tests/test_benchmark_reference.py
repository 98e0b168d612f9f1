"""The plain reference against the program's CPU path at small sizes, and
the comparison that decides ``correct`` shown to fail: for the control
(the reference in fp8 in the program's place) and for a run whose timed
path is broken underneath, once for each fault a cell can have."""

import json

import pytest

from benchmark import calibrate, faults, harness
from benchmark.tests.small import CONFIGS, SMALL, SMALL_TRAIN, run_small, small_cell, small_mix

# (small configuration, whether it stands in for the training cell)
CASES = [(c, False) for c in sorted(SMALL)] + [(c, True) for c in sorted(SMALL_TRAIN)]
IDS = [f"{c}-{'train' if t else 'generate'}" for c, t in CASES]


def limits(config, train):
    cell = (SMALL_TRAIN if train else SMALL)[config]
    return harness.read_json(harness.HERE / "workloads" / f"{cell}.json")["limits"]


@pytest.mark.parametrize("config,train", CASES, ids=IDS)
def test_reference_follows_the_program_in_float32(config, train, tmp_path):
    cfg = json.loads((CONFIGS / f"{config}.json").read_text())
    cfg["train_dtype" if train else "generate_dtype"] = "float32"
    path = tmp_path / f"{config}.json"
    path.write_text(json.dumps(cfg))
    result, checks = run_small(config, config_path=path, train=train)
    assert result["failed"] == 0
    for name, c in checks.items():
        assert c["value"] < 1e-4, (name, c)


@pytest.mark.parametrize("config,train", CASES, ids=IDS)
def test_bf16_run_is_correct(config, train):
    result, checks = run_small(config, train=train)
    assert result["correct"], checks
    assert set(checks) == set(limits(config, train))


@pytest.mark.parametrize("config,train", CASES, ids=IDS)
def test_control_is_not_correct(config, train):
    """The reference with fp8 operands, put in the program's place, reads
    above a limit of the cell on every seed tried, through the run's own
    path."""
    from benchmark.reference.model import fp8_round

    lim = limits(config, train)
    rows = calibrate.readings(small_cell(config, train), [11, 12, 13], 0.05, "cpu", fp8_round,
                              config_path=CONFIGS / f"{config}.json", mix=small_mix(train))
    for row in rows:
        assert row["correct"] and all(row["program"][k] <= v for k, v in lim.items()), row
        assert any(row["control"][k] > v for k, v in lim.items()), row


@pytest.mark.parametrize("config,train,fault", [
    (c, t, f) for c, t in CASES for f in faults.BY_DRIVER["train" if t else "generate"]])
def test_broken_timed_path_is_not_correct(config, train, fault, monkeypatch):
    p = json.loads((CONFIGS / f"{config}.json").read_text())["model"]["params"]
    faults.FAULTS[fault](monkeypatch.setattr, p["use_cids"], p["codebook_size"])
    result, checks = run_small(config, train=train)
    assert not result["correct"], checks
