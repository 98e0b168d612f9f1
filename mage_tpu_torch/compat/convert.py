"""Convert checkpoints between the reference (PyTorch) repository and the
port, both directions.

The port's counterpart of ``mage_tpu/compat/convert.py``. The port's keys
are the reference's, so a conversion unwraps and validates: ``vqvae`` and
``mage`` read a reference file (a state dict, under ``state_dict`` or not,
with or without DDP's ``module.`` prefix), load it strictly into the model
it names, and write the port's own checkpoint: ``{"step", "state_dict"}``
for a VQ-VAE (a first stage's ``ckpt_path``), ``{"step", "model"}`` for the
stage-2 core (what ``cli.main_mage --test_model`` reads; put it next to the
run's ``config.yaml``). A reference MAGE file's ``first_stage_model.*``
entries are left out, as JAX's importer leaves them: the config's first
stage supplies them. ``export-vqvae`` and ``export-mage`` write the
reference's plain state dict back out (``--first-stage`` merges a VQ-VAE
under ``first_stage_model.``). Everything runs on the CPU.

    python -m mage_tpu_torch.compat.convert vqvae --input caterv1.pt \\
        --down-ratio 8 --output models/vqvae_f8_cater/caterv1
    python -m mage_tpu_torch.compat.convert mage --input model_best.pth \\
        --config config/mage_caterv1.yaml --output results/imported/model_best
    python -m mage_tpu_torch.compat.convert export-vqvae \\
        --input models/vqvae_f8_cater/best --output caterv1_exported.pt
    python -m mage_tpu_torch.compat.convert export-mage \\
        --input results/mage/model_best --config config/mage_caterv1.yaml \\
        [--first-stage models/vqvae_f8_cater/best] --output model_exported.pth
"""

from __future__ import annotations

import argparse
import os

import torch

from mage_tpu_torch.compat.reference import load_reference_checkpoint
from mage_tpu_torch.models.pipeline import FIRST_STAGE_PREFIX


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="kind", required=True)
    pv = sub.add_parser("vqvae")
    pv.add_argument("--input", required=True, help="reference .pt file")
    pv.add_argument("--down-ratio", type=int, default=8, choices=[4, 8])
    pv.add_argument("--output", required=True)
    pm = sub.add_parser("mage")
    pm.add_argument("--input", required=True, help="reference .pth file")
    pm.add_argument("--config", required=True, help="YAML config of the model")
    pm.add_argument("--output", required=True)
    pev = sub.add_parser("export-vqvae")
    pev.add_argument("--input", required=True, help="the port's VQ-VAE checkpoint")
    pev.add_argument("--output", required=True, help=".pt file")
    pem = sub.add_parser("export-mage")
    pem.add_argument("--input", required=True, help="the port's stage-2 checkpoint")
    pem.add_argument("--config", required=True, help="YAML config of the model")
    pem.add_argument("--first-stage", default="",
                     help="the port's VQ-VAE checkpoint to merge as first_stage_model.*")
    pem.add_argument("--output", required=True, help=".pth file")
    return p.parse_args(argv)


def vqvae_from_state_dict(sd: dict, down_ratio: int):
    """The ``VectorQuantizedVAE`` whose shapes ``sd`` has (width and input
    channels from the first conv, K from the codebook), ``sd`` loaded
    strictly."""
    from mage_tpu_torch.models.vqvae import VectorQuantizedVAE

    dim, input_dim = sd["encoder.0.weight"].shape[:2]
    model = VectorQuantizedVAE(input_dim=input_dim, down_ratio=down_ratio, dim=dim,
                               K=sd["codebook.embedding.weight"].shape[0])
    model.load_state_dict(sd, strict=True)
    return model


def core_state_dict(sd: dict, config: str) -> dict:
    """``sd`` without its first-stage entries, checked by a strict load into
    the core ``config`` builds (on the CPU)."""
    from mage_tpu_torch.models.pipeline import build_pipeline

    core = {k: v for k, v in sd.items() if not k.startswith(FIRST_STAGE_PREFIX)}
    build_pipeline(config, device="cpu").core.load_state_dict(core, strict=True)
    return core


def _restore(path: str, key: str) -> dict:
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return ckpt[key] if isinstance(ckpt, dict) and key in ckpt else ckpt


def _save(obj, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(obj, path)


def main(argv=None):
    args = parse_args(argv)
    if args.kind == "vqvae":
        sd = load_reference_checkpoint(args.input)
        vqvae_from_state_dict(sd, args.down_ratio)
        _save({"step": 0, "state_dict": sd}, args.output)
    elif args.kind == "mage":
        sd = core_state_dict(load_reference_checkpoint(args.input), args.config)
        _save({"step": 0, "model": sd}, args.output)
    elif args.kind == "export-vqvae":
        sd = _restore(args.input, "state_dict")
        _save(sd, args.output)
    else:
        sd = core_state_dict(_restore(args.input, "model"), args.config)
        if args.first_stage:
            for k, v in _restore(args.first_stage, "state_dict").items():
                sd[FIRST_STAGE_PREFIX + k] = v
        _save(sd, args.output)
    n = sum(v.numel() for v in sd.values())
    print(f"{args.kind}: {len(sd)} tensors, {n:,} values -> {args.output}")
    return args.output


if __name__ == "__main__":
    main()
