"""Stage-1 KL-autoencoder training CLI (the MAGE+ first stage).

The port of the root ``train_autoencoder_kl.py``: MSE reconstruction +
``--kl-weight`` x KL (the LDM recipe without its adversarial and
perceptual terms) on the per-frame datasets of ``train_vqvae``, Adam at
``--lr``, per-epoch validation in eval mode (where the decoder runs the
fused GroupNorm-SiLU-conv3x3 kernel), ``best`` and ``model_{epoch}``
checkpoints (the ldm layout a MAGE+ config names as ``ckpt_path``).

One device, ``--device`` (default ``cuda``).

    python -m mage_tpu_torch.cli.train_autoencoder_kl --dataset mnist \\
        --data-root data/moving_mnist/mnist_single_20f_10k_ --resolution 64 \\
        --ch 64 --ch-mult 1 2 4 --output-folder kl_f4_mnist
"""

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="KL autoencoder (PyTorch/CUDA)")
    p.add_argument("--data-root", type=str, required=True)
    p.add_argument("--dataset", type=str, default="cater_gen", choices=["mnist", "cater_gen"])
    p.add_argument("--resolution", type=int, default=128)
    p.add_argument("--ch", type=int, default=128)
    p.add_argument("--ch-mult", type=int, nargs="+", default=[1, 2, 4, 4])
    p.add_argument("--num-res-blocks", type=int, default=2)
    p.add_argument("--z-channels", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--num-epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=4.5e-6)
    p.add_argument("--kl-weight", type=float, default=1e-6)
    p.add_argument("--output-folder", type=str, default="kl_f8_cater")
    p.add_argument("--log-folder", type=str, default="./models/log")
    p.add_argument("--model-folder", type=str, default="./models/autoencoders")
    p.add_argument("--resume", type=str, default="")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cpu runs the kernels' plain versions")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    from mage_tpu_torch.cli.train_vqvae import build_datasets
    from mage_tpu_torch.data.loader import Loader
    from mage_tpu_torch.models.autoencoder_kl import AutoencoderKL
    from mage_tpu_torch.models.pipeline import resolve_device
    from mage_tpu_torch.training.autoencoder_kl_trainer import KLAETrainer

    device = resolve_device(args.device)
    train_ds, test_ds, num_channels, _ = build_datasets(args)
    model = AutoencoderKL(
        embed_dim=args.z_channels,
        ch=args.ch,
        ch_mult=tuple(args.ch_mult),
        num_res_blocks=args.num_res_blocks,
        in_channels=num_channels,
        out_ch=num_channels,
        z_channels=args.z_channels,
        resolution=args.resolution,
    )
    trainer = KLAETrainer(
        model,
        lr=args.lr,
        kl_weight=args.kl_weight,
        log_dir=os.path.join(args.log_folder, args.output_folder),
        ckpt_dir=os.path.join(args.model_folder, args.output_folder),
        seed=args.seed,
        device=device,
    )
    trainer.init_state()
    if args.resume:
        trainer.resume(args.resume)
        print(f"=> loaded checkpoint '{args.resume}'")

    loader = Loader(train_ds, args.batch_size, shuffle=True, seed=args.seed, drop_last=True)
    test_loader = Loader(test_ds, args.batch_size, shuffle=False, drop_last=True)
    trainer.fit(loader, test_loader, args.num_epochs, log_every=args.log_every)


if __name__ == "__main__":
    main()
