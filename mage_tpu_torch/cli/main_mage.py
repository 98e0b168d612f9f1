"""Stage-2 MAGE training / sampling CLI.

The port of the root ``main_mage.py`` (the reference's main_mage.py
surface, :29-56,276-297): ``--split train`` trains from a YAML config,
saving a config snapshot next to the checkpoints (:64-67); ``--split test``
reloads the snapshot from the checkpoint directory, restores the stage-2
weights and samples autoregressively, writing GIFs (:201-257).

One device, ``--device`` (default ``cuda``), or with ``--multihost`` one
process per device under ``torchrun``: training is data parallel over
every rank (``train.batchsize`` is the global batch; each rank loads its
shard; ``train.fsdp`` shards the parameters over the ranks too), rank 0
writing the snapshot, logs and checkpoints. The config's targets name
``mage_tpu.*`` classes and resolve to the port's (``config.resolve_target``).

    python -m mage_tpu_torch.cli.main_mage --config config/mage_mnist.yaml \\
        --split train --checkpoint-path results/mage_mnist
    python -m mage_tpu_torch.cli.main_mage --split test \\
        --test_model results/mage_mnist/model_best --max-test-items 4
    torchrun --nproc_per_node 4 -m mage_tpu_torch.cli.main_mage --multihost \\
        --config config/mage_mnist.yaml --split train
"""

import argparse
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", type=str, default="config/mage_caterv1.yaml")
    p.add_argument("--split", type=str, default="train", choices=["train", "test"])
    p.add_argument("--checkpoint-path", type=str, default="./results/mage")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", type=str, default="",
                   help="checkpoint name/path to resume training from")
    p.add_argument("--n_samples", type=int, default=1,
                   help="samples to produce per test instance")
    p.add_argument("--test_model", type=str, default="",
                   help="checkpoint (next to its config.yaml) to sample from")
    p.add_argument("--max-test-items", type=int, default=-1)
    p.add_argument("--sample-batch-size", type=int, default=1)
    p.add_argument("--save-gifs", action="store_true", default=True)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 stage-2 core for sampling; the frozen first "
                        "stage stays f32 so conditioning ids match the f32 run")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="stochastic id decoding temperature (0 = greedy "
                        "reference parity; discrete models only)")
    p.add_argument("--top-k", type=int, default=0,
                   help="restrict stochastic decoding to the top-k logits "
                        "(0 = no restriction; needs --temperature > 0)")
    p.add_argument("--kv-quant", type=str, default=None, choices=["int8", "int4"],
                   help="store the cached sampler's K/V cache as int8 or int4 "
                        "codes with per-head scales (default: unquantized)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cpu runs the kernels' plain versions")
    p.add_argument("--multihost", action="store_true",
                   help="join the process group torchrun describes (nccl on the card, "
                        "gloo with --device cpu); training is data parallel over it")
    return p.parse_args(argv)


def build(configs, split: str, seed: int):
    from mage_tpu_torch.config import instantiate_from_config

    return instantiate_from_config(configs.data, {"split": split, "seed": seed})


def build_pipeline(configs, opt):
    from mage_tpu_torch.config import instantiate_from_config

    return instantiate_from_config(configs.model, merge={"device": opt.device,
                                                         "seed": opt.seed,
                                                         "kv_quant": opt.kv_quant})


def train(opt, mesh=None) -> None:
    from mage_tpu_torch.config import load_config, save_config
    from mage_tpu_torch.data.loader import Loader, PrefetchLoader
    from mage_tpu_torch.parallel.mesh import axis_index, axis_size, is_main_rank
    from mage_tpu_torch.training.mage_trainer import MageTrainer

    configs = load_config(opt.config)
    os.makedirs(opt.checkpoint_path, exist_ok=True)
    if is_main_rank(mesh):
        save_config(configs, os.path.join(opt.checkpoint_path, "config.yaml"))

    train_dataset = build(configs, "train", opt.seed)
    test_dataset = build(configs, "test", opt.seed)
    pipeline = build_pipeline(configs, opt)

    trainer = MageTrainer(pipeline, configs.train, opt.checkpoint_path, mesh=mesh,
                          seed=opt.seed)
    bs = int(configs.train.batchsize)  # global batch size
    n_data, index = axis_size(mesh, "data"), axis_index(mesh, "data")
    if bs % n_data:
        raise SystemExit(f"batchsize {bs} not divisible by {n_data} devices")
    # each rank's share (reference main_mage.py:93)
    base_loader = Loader(train_dataset, bs // n_data, shuffle=True, seed=opt.seed,
                         drop_last=True, num_shards=n_data, shard_index=index)
    # overlap host decode/collate with device steps
    train_loader = PrefetchLoader(base_loader)
    test_loader = Loader(test_dataset, bs // n_data, shuffle=False, drop_last=True,
                         num_shards=n_data, shard_index=index)

    # the JAX CLI reads one batch to shape its state; reading it here too
    # keeps the datasets' random streams (speeds, crops) the same as there
    next(iter(base_loader))
    trainer.init_state()
    start_epoch = 0
    if opt.resume:
        trainer.resume(opt.resume)
        # resume the LR schedule from the epoch the iteration count implies
        start_epoch = trainer.iteration // max(len(train_loader), 1)
        print(
            f"=> resumed from '{opt.resume}' at iteration {trainer.iteration}"
            f" (epoch {start_epoch})"
        )
    trainer.fit(train_loader, test_loader, start_epoch=start_epoch)


def sampling(opt) -> int:
    """Sample the test split; returns the number of items done."""
    import torch

    from mage_tpu_torch.config import load_config
    from mage_tpu_torch.data.loader import Loader
    from mage_tpu_torch.training.checkpoint import Checkpointer
    from mage_tpu_torch.utils.media import save_gif

    test_model = opt.test_model or os.path.join(opt.checkpoint_path, "model_best")
    ckpt_dir = os.path.dirname(os.path.abspath(test_model))
    configs = load_config(os.path.join(ckpt_dir, "config.yaml"))
    test_dataset = build(configs, "test", opt.seed)
    pipeline = build_pipeline(configs, opt)

    restored = Checkpointer(ckpt_dir).restore(os.path.abspath(test_model),
                                              map_location=pipeline.device)
    pipeline.core.load_state_dict(restored["model"])
    del restored
    print(f"=> loaded checkpoint '{test_model}'")
    if opt.bf16:
        # the stage-2 core in bf16; the frozen first stage STAYS f32 so the
        # VQ argmin yields the same conditioning ids as an f32 run (the same
        # contract as bf16 training)
        pipeline.core.to(torch.bfloat16)

    # reference sampling uses batch 1 (main_mage.py:205); larger batches
    # amortize the AR loop across the card
    bs = max(1, opt.sample_batch_size)
    loader = Loader(test_dataset, bs, shuffle=True, seed=opt.seed, drop_last=bs > 1)
    generator = torch.Generator(device=pipeline.device).manual_seed(opt.seed)
    out_dir = os.path.join(ckpt_dir, "videos")
    done = 0
    for batch in loader:
        if 0 <= opt.max_test_items <= done:
            break
        video_ids = batch.pop("video_id", [f"sample_{done + i}" for i in range(bs)])
        for s in range(opt.n_samples):
            videos = pipeline.generate(batch, temperature=opt.temperature, top_k=opt.top_k,
                                       generator=generator)
            videos = np.clip(videos.float().cpu().numpy(), -1.0, 1.0)
            if opt.save_gifs:
                for i, video_id in enumerate(video_ids):
                    name = (
                        f"{os.path.splitext(video_id)[0]}-"
                        f"{float(batch['speed'][i]):.4f}"
                    )
                    if opt.n_samples > 1:
                        name += f"-s{s}"
                    save_gif(videos[i], os.path.join(out_dir, name + ".gif"), fps=3)
        done += len(video_ids)
        print(done)
    return done


def main(argv=None):
    """``--split train`` returns None; ``--split test`` the items sampled."""
    opt = parse_args(argv)
    import torch.distributed as dist

    from mage_tpu_torch.models.pipeline import resolve_device
    from mage_tpu_torch.parallel import init_distributed, make_mesh

    if not opt.multihost:
        resolve_device(opt.device)
        return train(opt) if opt.split == "train" else sampling(opt)
    device = init_distributed(opt.device)
    opt.device = str(device)
    try:
        if opt.split == "train":
            return train(opt, make_mesh({"data": -1}, device.type))
        return sampling(opt)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
