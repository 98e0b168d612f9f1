"""One full MAGE training step on an N-rank mesh, at tiny shapes.

The port's twin of ``__graft_entry__.py``'s ``dryrun_multichip``: data
parallelism over a ``data`` axis composed with tensor parallelism over a
``model`` axis (2 ranks when N is even and at least 4) and FSDP over the
data axis (``fsdp_min_size`` 1024, so the tiny model's tensors split). It
spawns N ranks (gloo on the CPU with ``--device cpu``, else nccl with one
card per rank), asserts that FSDP and TP each placed something, and prints
the mesh, the placement counts and the loss.

    python -m mage_tpu_torch.parallel.dryrun --devices 4 --device cpu
"""

from __future__ import annotations

import argparse
import socket
import tempfile

import numpy as np
import torch
import torch.distributed as dist


def tiny_pipeline(device="cpu", frames_length: int = 4, res: int = 8, width: int = 64,
                  k: int = 32, text_ctx: int = 12, dropout: float = 0.1, seed: int = 0):
    """The tiny MAGE (f4 VQ-VAE on 32-px frames, width 64, 3 decoder
    layers, the stochastic branch on) of ``__graft_entry__._tiny_pipeline``."""
    from mage_tpu_torch.models.pipeline import MagePipeline

    return MagePipeline(
        first_stage_config={"target": "mage_tpu.models.vqvae.VectorQuantizedVAE",
                            "params": {"input_dim": 1, "dim": 16, "down_ratio": 4, "K": k}},
        text_encoder_config={"target": "mage_tpu.models.layers.TransformerTextEncoder",
                             "params": {"vocab_size": 30, "context_length": text_ctx,
                                        "transformer_width": width, "transformer_layers": 1,
                                        "output_dim": width, "padding_idx": 0,
                                        "dropout": dropout}},
        ma_config={"target": "mage_tpu.models.layers.MAEncoder",
                   "params": {"layers": 1, "d_model": width}},
        generate_decoder_config={"target": "mage_tpu.models.mage.FlatAxialDecoder",
                                 "params": {"in_channels": width, "out_channels": k,
                                            "model_channels": width,
                                            "frames_length": frames_length, "layers": 3}},
        codebook_size=k, frames_length=frames_length, image_resolution=res,
        vision_width=width, dropout=dropout, use_cids=True, randomness=True,
        alpha=0.001, beta=0.00025, device=device, seed=seed)


def tiny_batch(pipeline, batch_size: int, height: int = 32, width_px: int = 32,
               channels: int = 1, rng_seed: int = 0) -> dict:
    """``__graft_entry__._batch``: random frames, 4-word captions, speeds."""
    rng = np.random.RandomState(rng_seed)
    length = pipeline.frames_length
    images = rng.rand(batch_size, length, height, width_px, channels).astype(np.float32) - 0.5
    text = np.zeros((batch_size, 12), np.int32)
    text[:, 0] = 1
    text[:, 1:5] = rng.randint(3, 29, size=(batch_size, 4))
    text[:, 5] = 2
    return {"images": images, "text": text,
            "speed": rng.rand(batch_size).astype(np.float32)}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank: int, n: int, port: int, device_type: str) -> None:
    from torch.distributed.tensor import Shard

    from mage_tpu_torch.config import Config
    from mage_tpu_torch.parallel import make_mesh, shard_batch
    from mage_tpu_torch.training.mage_trainer import MageTrainer

    device = torch.device("cpu") if device_type == "cpu" else torch.device("cuda", rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)  # the ranks share the host's cores
    dist.init_process_group("gloo" if device.type == "cpu" else "nccl",
                            init_method=f"tcp://localhost:{port}", rank=rank, world_size=n)
    try:
        tp = 2 if n % 2 == 0 and n >= 4 else 1
        mesh = make_mesh({"data": n // tp, "model": tp}, device.type)
        if rank == 0:
            print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))}", flush=True)
        pipeline = tiny_pipeline(device)
        cfg = Config({"epoch": 1, "batchsize": 2 * n, "lr": 1e-3, "checkpoint_every": 10,
                      "fsdp": True, "fsdp_min_size": 1024})
        with tempfile.TemporaryDirectory() as td:
            trainer = MageTrainer(pipeline, cfg, td, mesh=mesh)
            trainer.init_state()
            batch = shard_batch(tiny_batch(pipeline, 2 * n), mesh, device=device)
            terms = trainer.train_step(batch, 1e-3, trainer.beta, pipeline.alpha,
                                       generator=torch.Generator(device).manual_seed(0))
        loss = float(terms["final_loss"])
        if not np.isfinite(loss):
            raise RuntimeError(f"non-finite loss {loss}")
        split = [[name for name, p in zip(mesh.mesh_dim_names, m.placements)
                  if isinstance(p, Shard)] for m, _ in trainer.masters.values()]
        n_fsdp = sum("data" in s for s in split)
        n_tp = sum("model" in s for s in split)
        if n_fsdp == 0:
            raise RuntimeError("FSDP placed nothing: check fsdp_min_size")
        # pin the TP axis too: a regression in param_spec's key matching
        # would otherwise report model-sharded=0 and still pass
        if tp > 1 and n_tp == 0:
            raise RuntimeError("TP axis placed nothing: param_spec regression?")
        if rank == 0:
            print(f"dryrun_multichip({n}): ok, loss={loss:.4f}, params data-sharded={n_fsdp} "
                  f"model-sharded={n_tp} of {len(split)}", flush=True)
    finally:
        dist.destroy_process_group()


def spawn(fn, args: tuple, nprocs: int, timeout: float = 600.0) -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` spawned processes; raises if a
    rank fails, and kills them all after ``timeout`` seconds."""
    import time

    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, start_method="spawn", join=False)
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() >= deadline:
            for proc in ctx.processes:
                proc.kill()
            raise TimeoutError(f"{nprocs} ranks did not finish in {timeout} s")


def run(n_devices: int, device: str = "cuda") -> None:
    """Spawn the ``n_devices`` ranks and run the step; raises if a rank fails."""
    device_type = torch.device(device).type
    if device_type == "cuda":
        from mage_tpu_torch.models.pipeline import resolve_device

        resolve_device(device)
        if torch.cuda.device_count() < n_devices:
            raise RuntimeError(f"{n_devices} ranks need {n_devices} cards; "
                               f"{torch.cuda.device_count()} present (--device cpu: gloo)")
    spawn(_worker, (n_devices, free_port(), device_type), n_devices)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--devices", type=int, default=8)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda: nccl, one card per rank; cpu: gloo ranks on the CPU")
    args = p.parse_args(argv)
    run(args.devices, args.device)


if __name__ == "__main__":
    main()
