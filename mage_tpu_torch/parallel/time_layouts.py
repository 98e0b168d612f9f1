"""Seconds per MAGE train step under each mesh layout, on N cards.

Spawns N ranks (nccl, one card each; gloo ranks on the CPU with ``--device
cpu``) per layout, builds the pipeline of a YAML config at its full width
with random weights, and times ``MageTrainer`` steps on one global batch,
the frozen first-stage encode included: a warm-up step, then ``--steps``
steps, each from a synchronised start to a synchronised end on every rank,
the step's time the slowest rank's. It prints one JSON line per layout (the
mesh, the per-rank batch, each step's seconds, rank 0's peak memory on the
card) and, first on the card, the cards' name and power limit as
``nvidia-smi`` gives them.

    python -m mage_tpu_torch.parallel.time_layouts --devices 4 \\
        --layouts data=4 data=2,model=2 --batch 16
"""

from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
import time

import torch
import torch.distributed as dist

from mage_tpu_torch.parallel import dryrun


def parse_layout(text: str) -> dict:
    """``data=2,model=2`` -> {"data": 2, "model": 2}."""
    return {k: int(v) for k, v in (part.split("=") for part in text.split(","))}


def _batch(batch: int, frames: int, res: int, channels: int, context: int,
           device: torch.device, seed: int = 0) -> dict:
    """Frames uniform in [-0.5, 0.5], a caption of 1, four words in 3..28
    and 2, a uniform speed (``bench_train.py``'s batch), on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    text = torch.zeros(batch, context, dtype=torch.int64, device=device)
    text[:, 0] = 1
    text[:, 1:5] = torch.randint(3, 29, (batch, 4), generator=gen, device=device)
    text[:, 5] = 2
    images = torch.rand(batch, frames, res, res, channels, generator=gen, device=device)
    return {"images": images - 0.5, "text": text,
            "speed": torch.rand(batch, generator=gen, device=device)}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dist.barrier()


def _worker(rank: int, n: int, port: int, layout: dict, args: argparse.Namespace,
            out: str) -> None:
    from mage_tpu_torch.config import Config
    from mage_tpu_torch.models.pipeline import build_pipeline
    from mage_tpu_torch.parallel import make_mesh, shard_batch
    from mage_tpu_torch.training.mage_trainer import MageTrainer

    if args.device == "cpu":
        device = torch.device("cpu")
        torch.set_num_threads(1)  # the ranks share the host's cores
    else:
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    dist.init_process_group("gloo" if device.type == "cpu" else "nccl",
                            init_method=f"tcp://localhost:{port}", rank=rank, world_size=n)
    try:
        mesh = make_mesh(layout, device.type)
        pipe = build_pipeline(args.config, args.frames, device=device, seed=0,
                              dropout=args.dropout)
        cfg = Config({"epoch": 1, "batchsize": args.batch, "lr": 5e-5,
                      "checkpoint_every": 10 ** 9, "fsdp": args.fsdp})
        batch = shard_batch(_batch(args.batch, args.frames, args.res, args.channels,
                                   args.context, device), mesh)
        with tempfile.TemporaryDirectory() as tmp:
            trainer = MageTrainer(pipe, cfg, tmp, mesh=mesh)
            trainer.init_state()
            gen = torch.Generator(device=device).manual_seed(0)
            times = []
            for i in range(args.steps + 1):
                _sync(device)
                start = time.perf_counter()
                terms = trainer.train_step(batch, 5e-5, trainer.beta, pipe.alpha,
                                           generator=gen)
                _sync(device)
                if i:
                    times.append(time.perf_counter() - start)
        slowest = torch.tensor(times, device=device, dtype=torch.float64)
        dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
        if rank == 0:
            line = {"mesh": layout, "fsdp": args.fsdp, "global_batch": args.batch,
                    "rank_batch": batch["images"].shape[0], "frames": args.frames,
                    "config": args.config, "s_per_step": slowest.tolist(),
                    "final_loss": float(terms["final_loss"]),
                    "peak_gib_rank0": (torch.cuda.max_memory_allocated(device) / 2 ** 30
                                       if device.type == "cuda" else None)}
            with open(out, "a") as f:
                f.write(json.dumps(line) + "\n")
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--devices", type=int, default=4)
    p.add_argument("--layouts", nargs="+", default=["data=4", "data=2,model=2"])
    p.add_argument("--config", default="config/mage_caterv1.yaml")
    p.add_argument("--batch", type=int, default=16, help="global batch")
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--res", type=int, default=128, help="frame side in pixels")
    p.add_argument("--channels", type=int, default=3, help="frame channels")
    p.add_argument("--context", type=int, default=32, help="caption length")
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--fsdp", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda: nccl, one card per rank; cpu: gloo ranks on the CPU")
    args = p.parse_args(argv)
    if args.device != "cpu":
        from mage_tpu_torch.models.pipeline import resolve_device

        resolve_device(args.device)
        if torch.cuda.device_count() < args.devices:
            raise RuntimeError(f"{args.devices} ranks need {args.devices} cards; "
                               f"{torch.cuda.device_count()} present")
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        out = f"{tmp}/lines.jsonl"
        for text in args.layouts:
            dryrun.spawn(_worker, (args.devices, dryrun.free_port(), parse_layout(text),
                                   args, out), args.devices, timeout=900.0)
        with open(out) as f:
            print(f.read().strip(), flush=True)


if __name__ == "__main__":
    main()
