"""Shared pieces of the benchmark's CPU tests: the small configurations
under ``configs/`` and small traffic mixes, driven through the harness's
own ``run_cell`` on the CPU (it skips only the look for a card)."""

import time
from pathlib import Path

CONFIGS = Path(__file__).resolve().parent / "configs"
SMALL_MIX = {"driver": "generate", "batch": 2, "resolution": 32, "cached": True,
             "spatial_attn": "flat", "pool": 2, "warmup_calls": 1, "profile_calls": 1,
             "check_clips": 4}
SMALL_TRAIN_MIX = {"driver": "train", "batch": 4, "resolution": 32, "pool": 4,
                   "check_steps": 3, "warmup_steps": 1, "profile_steps": 1}
# the cells the small configurations stand in for, whose limits they are held to
SMALL = {"tiny_mage": "mage_gen_b32", "tiny_mageplus": "mageplus_gen_b32"}
SMALL_TRAIN = {"tiny_mage": "mage_train_b16"}


def small_cell(config: str, train: bool = False) -> dict:
    if train:
        return {"name": SMALL_TRAIN[config], "config": config, "traffic": "train_b16",
                "chips": 1}
    return {"name": SMALL[config], "config": config, "traffic": "gen_b32", "chips": 1}


def small_mix(train: bool = False) -> dict:
    return dict(SMALL_TRAIN_MIX if train else SMALL_MIX)


def run_small(config: str, seed: int = 987654321012, seconds: float = 0.05,
              config_path=None, train: bool = False):
    """One run of the small copy of a cell on the CPU -> (result, checks)."""
    from benchmark import run

    return run.run_cell(small_cell(config, train), seed, seconds, False, "cpu", time.time(),
                        config_path=config_path or CONFIGS / f"{config}.json",
                        mix=small_mix(train))
