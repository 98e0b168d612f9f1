"""Stage-1 VQ-VAE training CLI.

The port of the root ``train_vqvae.py`` (the reference's train_vqvae.py
surface, :184-253): dataset selection (mnist 64 px / down 4, cater_gen
128 px / down 8), Adam at ``--lr``, the 3-term loss with commitment
``--beta``, per-epoch validation, ``best`` and ``model_{epoch}``
checkpoints (one ``torch.save`` file each, which a stage-2 config names as
its first stage's ``ckpt_path``), reconstruction grids.

One device, ``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
versions), or with ``--multihost`` one process per device under
``torchrun``: data parallel over every rank (``--batch-size`` is the global
batch; each rank loads its shard), rank 0 writing logs and checkpoints.

    python -m mage_tpu_torch.cli.train_vqvae --dataset mnist \\
        --data-root data/moving_mnist/mnist_single_20f_10k_ --output-folder mnist_512_256
    torchrun --nproc_per_node 4 -m mage_tpu_torch.cli.train_vqvae --multihost ...
"""

import argparse
import os

import numpy as np


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="VQ-VAE (PyTorch/CUDA)")
    parser.add_argument(
        "--data-root", type=str, default="./data/moving_mnist/mnist_single_20f_10k_"
    )
    parser.add_argument("--dataset", type=str, default="mnist", choices=["mnist", "cater_gen"])
    parser.add_argument("--hidden-size", type=int, default=256)
    parser.add_argument("--k", type=int, default=512)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--num-epochs", type=int, default=200)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--beta", type=float, default=2.0, help="commitment loss weight")
    parser.add_argument("--output-folder", type=str, default="mnist_512_256")
    parser.add_argument("--log-folder", type=str, default="./models/log")
    parser.add_argument("--model-folder", type=str, default="./models/model")
    parser.add_argument("--resume", type=str, default="")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--log-every", type=int, default=50)
    parser.add_argument("--codebook-restart", action="store_true",
                        help="re-seed dead codebook entries each epoch "
                             "(beyond reference: revival insurance against "
                             "codebook collapse)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; cpu runs the kernels' plain versions")
    parser.add_argument("--multihost", action="store_true",
                        help="join the process group torchrun describes: data parallel "
                             "over every rank (nccl on the card, gloo with --device cpu)")
    return parser.parse_args(argv)


def build_datasets(args):
    """-> (train, test, channels, down ratio) for ``args.dataset``: one
    randomly cropped frame per clip (mnist) or per image (cater_gen)."""
    from mage_tpu_torch.data import transforms as T
    from mage_tpu_torch.data.datasets import CATER4VQVAE, MovingMnist4VQVAE

    if args.dataset == "mnist":
        transform = T.Compose(
            [
                T.RandomResizedCrop(64, scale=(0.8, 1.0)),
                T.ToFloat(),
                T.Normalize([0.5], [1.0]),
            ]
        )
        train = MovingMnist4VQVAE(args.data_root, "train", transform, seed=args.seed)
        test = MovingMnist4VQVAE(args.data_root, "test", transform, seed=args.seed)
        return train, test, 1, 4
    transform = T.Compose(
        [
            T.RandomResizedCrop(128, scale=(0.8, 1.0)),
            T.ToFloat(),
            T.Normalize([0.5], [0.5]),
        ]
    )
    train = CATER4VQVAE(args.data_root, "train", transform, seed=args.seed)
    test = CATER4VQVAE(args.data_root, "test", transform, seed=args.seed)
    return train, test, 3, 8


def main(argv=None) -> None:
    args = parse_args(argv)
    import torch.distributed as dist

    from mage_tpu_torch.models.pipeline import resolve_device
    from mage_tpu_torch.parallel import init_distributed, make_mesh

    mesh, n_proc, proc = None, 1, 0
    if args.multihost:
        device = init_distributed(args.device)
        mesh = make_mesh({"data": -1}, device.type)
        n_proc, proc = dist.get_world_size(), dist.get_rank()
    else:
        device = resolve_device(args.device)
    try:
        _train(args, device, mesh, n_proc, proc)
    finally:
        if args.multihost:
            dist.destroy_process_group()


def _train(args, device, mesh, n_proc: int, proc: int) -> None:
    from mage_tpu_torch.data.loader import Loader, PrefetchLoader
    from mage_tpu_torch.models.vqvae import VectorQuantizedVAE
    from mage_tpu_torch.training.vqvae_trainer import VQVAETrainer

    if args.batch_size % n_proc:
        raise SystemExit(f"--batch-size {args.batch_size} not divisible by {n_proc} devices")
    train_ds, test_ds, num_channels, down_ratio = build_datasets(args)
    model = VectorQuantizedVAE(
        input_dim=num_channels, down_ratio=down_ratio, dim=args.hidden_size, K=args.k
    )
    trainer = VQVAETrainer(
        model,
        lr=args.lr,
        beta=args.beta,
        log_dir=os.path.join(args.log_folder, args.output_folder),
        ckpt_dir=os.path.join(args.model_folder, args.output_folder),
        seed=args.seed,
        codebook_restart=args.codebook_restart,
        device=device,
        mesh=mesh,
    )
    train_loader = PrefetchLoader(Loader(
        train_ds, args.batch_size // n_proc, shuffle=True, seed=args.seed, drop_last=True,
        num_shards=n_proc, shard_index=proc,
    ))  # overlap host decode/collate with device steps
    eval_bs = min(16 if 16 % n_proc == 0 else n_proc, len(test_ds))
    eval_bs = max((eval_bs // n_proc) * n_proc, n_proc)
    test_loader = Loader(test_ds, eval_bs // n_proc, shuffle=False, drop_last=True,
                         num_shards=n_proc, shard_index=proc)

    fixed = np.stack([test_ds[i] for i in range(min(16, len(test_ds)))])

    trainer.init_state()
    if args.resume:
        trainer.resume(args.resume)
        print(f"=> loaded checkpoint '{args.resume}'")

    trainer.fit(
        train_loader,
        test_loader,
        args.num_epochs,
        fixed_images=fixed,
        log_every=args.log_every,
    )


if __name__ == "__main__":
    main()
