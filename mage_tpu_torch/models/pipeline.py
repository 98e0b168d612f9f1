"""Two-stage TI2V pipeline for generation: frozen VQ-VAE + ``MAGECore``.

Port of ``mage_tpu/models/pipeline.py`` (discrete MAGE). ``MagePipeline``
is built from the same YAML ``model.params`` as the JAX class and owns both
stages as ``nn.Module``s; ``generate`` encodes the first frame, samples the
ids of the remaining frames, decodes them and prepends the first frame.

The entry points run on the card: ``device`` defaults to ``"cuda"`` and a
missing GPU raises unless the caller passes ``device="cpu"``. Weights are
random, drawn from a seeded ``torch.Generator`` (``init_weights``), until a
state dict is loaded (reference keys; ``first_stage_model.*`` for stage 1).
"""

from __future__ import annotations

import math
import os
from typing import Any, Mapping, Optional

import torch
from torch import nn

from mage_tpu_torch.config import instantiate_from_config, load_config, target_path
from mage_tpu_torch.models.layers import MAEncoder, TransformerTextEncoder
from mage_tpu_torch.models.mage import FlatAxialDecoder, MAGECore
from mage_tpu_torch.models.vqvae import VectorQuantizedVAE

FIRST_STAGE_PREFIX = "first_stage_model."


def resolve_device(device: Optional[str | torch.device]) -> torch.device:
    """``None`` means the GPU; asking for CUDA without one raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mage_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return device


def _chunked_frames(fn, flat: torch.Tensor, max_chunk: int = 512) -> torch.Tensor:
    """Apply a per-frame model over (N, ...) in chunks of at most
    ``max_chunk`` frames (the largest divisor of N up to it), bounding the
    activation memory of the batch-folded conv stacks."""
    n = flat.shape[0]
    if n <= max_chunk:
        return fn(flat)
    chunk = max_chunk
    while n % chunk:
        chunk -= 1
    if chunk <= 1:
        return fn(flat)
    return torch.cat([fn(c) for c in flat.split(chunk)], dim=0)


class FirstStageVQVAE:
    """Frozen VQ-VAE wrapper: video-batched encode/decode."""

    def __init__(self, model: VectorQuantizedVAE):
        self.model = model

    @classmethod
    def from_config(cls, params: Mapping[str, Any]) -> "FirstStageVQVAE":
        p = dict(params)
        ckpt_path = p.pop("ckpt_path", None)
        model = VectorQuantizedVAE(**p)
        if ckpt_path:
            # a reference-layout VQ-VAE state dict saved with torch.save
            model.load_state_dict(torch.load(ckpt_path, map_location="cpu",
                                             weights_only=True), strict=True)
        return cls(model)

    @property
    def dtype(self) -> torch.dtype:
        return self.model.codebook.embedding.weight.dtype

    @torch.no_grad()
    def encode(self, videos: torch.Tensor, max_chunk: int = 512) -> torch.Tensor:
        """(B, T, H, W, C) frames -> (B, T, h, w) int32 ids."""
        b, t = videos.shape[:2]
        flat = videos.reshape(b * t, *videos.shape[2:]).to(self.dtype)
        ids = _chunked_frames(self.model.encode, flat, max_chunk)
        return ids.reshape(b, t, *ids.shape[1:])

    @torch.no_grad()
    def decode(self, latents: torch.Tensor, max_chunk: int = 512) -> torch.Tensor:
        """(B, T, h, w) ids -> (B, T, H, W, C) frames."""
        b, t = latents.shape[:2]
        flat = latents.reshape(b * t, *latents.shape[2:])
        frames = _chunked_frames(self.model.decode, flat, max_chunk)
        return frames.reshape(b, t, *frames.shape[1:])


def _check_target(config: Mapping, default: type, what: str) -> None:
    target = config.get("target") if isinstance(config, Mapping) else None
    if target and target_path(str(target)) != f"{default.__module__}.{default.__name__}":
        raise NotImplementedError(
            f"{what} target {target!r}: the port builds {default.__name__} only")


class MagePipeline:
    """First stage + ``MAGECore`` + generation glue, from the YAML schema of
    ``config/mage_*.yaml`` (``model.params``). Discrete MAGE only."""

    def __init__(
        self,
        first_stage_config: Mapping[str, Any],
        text_encoder_config: Mapping[str, Any],
        ma_config: Mapping[str, Any],
        generate_decoder_config: Mapping[str, Any],
        codebook_size: int,
        frames_length: int,
        image_resolution: int,
        vision_width: int,
        use_cids: bool = False,
        randomness: bool = False,
        device: Optional[str | torch.device] = None,
        seed: int = 0,
        **training_params,
    ):
        # dropout, alpha, beta, v_kl, auto_beta, remat and the loss weights
        # configure training, which this port does not run yet
        del training_params
        self.device = resolve_device(device)
        fs_target = target_path(str(first_stage_config.get("target", "")))
        if fs_target.endswith("autoencoder_kl.AutoencoderKL") or not use_cids:
            raise NotImplementedError(
                "the continuous (MAGE+) pipeline with the KL-AE first stage is "
                "ROADMAP item A7; the port runs discrete MAGE (use_cids: true)")
        _check_target(first_stage_config, VectorQuantizedVAE, "first stage")
        _check_target(text_encoder_config, TransformerTextEncoder, "text encoder")
        _check_target(ma_config, MAEncoder, "motion-anchor encoder")
        _check_target(generate_decoder_config, FlatAxialDecoder, "decoder")
        self.use_cids = use_cids
        self.frames_length = frames_length
        self.first_stage = FirstStageVQVAE.from_config(first_stage_config.get("params", {}))
        te = dict(text_encoder_config.get("params", {}))
        ma = dict(ma_config.get("params", {}))
        dec = dict(generate_decoder_config.get("params", {}))
        self.core = MAGECore(
            codebook_size=codebook_size,
            frames_length=frames_length,
            image_resolution=image_resolution,
            vision_width=vision_width,
            randomness=randomness,
            text_vocab_size=te.get("vocab_size", 30),
            text_context_length=te.get("context_length", 32),
            text_width=te.get("transformer_width", 512),
            text_layers=te.get("transformer_layers", 2),
            text_output_dim=te.get("output_dim", 512),
            text_padding_idx=te.get("padding_idx", 0),
            ma_layers=ma.get("layers", 1),
            ma_d_model=ma.get("d_model", 512),
            dec_layers=dec.get("layers", 6),
            dec_out_channels=dec.get("out_channels", codebook_size),
        )
        init_weights(self.core, torch.Generator().manual_seed(seed))
        init_weights(self.first_stage.model, torch.Generator().manual_seed(seed + 1))
        self.to(self.device)
        self.core.eval()
        self.first_stage.model.eval()

    # ---- state ---------------------------------------------------------------

    def to(self, device=None, dtype: Optional[torch.dtype] = None) -> "MagePipeline":
        """Move both stages; ``dtype`` casts their floating-point weights
        (bf16 generation casts both, as the JAX bench does)."""
        for m in (self.core, self.first_stage.model):
            m.to(device=device, dtype=dtype)
        if device is not None:
            self.device = torch.device(device)
        return self

    @property
    def dtype(self) -> torch.dtype:
        return self.core.speed_embedding.dtype

    def state_dict(self) -> dict:
        """Reference MAGE layout: core keys plus ``first_stage_model.*``."""
        sd = dict(self.core.state_dict())
        for k, v in self.first_stage.model.state_dict().items():
            sd[FIRST_STAGE_PREFIX + k] = v
        return sd

    def load_state_dict(self, sd: Mapping[str, torch.Tensor]) -> None:
        """Strict load of a reference MAGE state dict (``first_stage_model.*``
        included)."""
        core = {k: v for k, v in sd.items() if not k.startswith(FIRST_STAGE_PREFIX)}
        fs = {k[len(FIRST_STAGE_PREFIX):]: v for k, v in sd.items()
              if k.startswith(FIRST_STAGE_PREFIX)}
        self.core.load_state_dict(core, strict=True)
        self.first_stage.model.load_state_dict(fs, strict=True)

    # ---- generation ------------------------------------------------------------

    @torch.no_grad()
    def generate(self, batch: Mapping[str, Any], *, video_noise=None,
                 generator: Optional[torch.Generator] = None,
                 cached: bool = True, temperature: float = 0.0,
                 top_k: int = 0) -> torch.Tensor:
        """batch (``images`` (B, L, H, W, C) of which frame 0 is used,
        ``text`` (B, ctx) ids, optional ``speed`` (B,)) -> video
        (B, L, H, W, C) with the given first frame prepended.

        ``video_noise`` (B, h, w, 64) is the prior sample of the stochastic
        branch; without it one is drawn from ``generator``. ``cached``
        selects the KV-cached sampler; ``temperature`` and
        ``top_k`` sample ids with it instead of the greedy argmax."""
        dev = self.device
        first = torch.as_tensor(batch["images"])[:, 0:1].to(device=dev,
                                                             dtype=self.first_stage.dtype)
        latents0 = self.first_stage.encode(first)
        text = torch.as_tensor(batch["text"]).to(dev)
        speed = batch.get("speed")
        if speed is not None:
            speed = torch.as_tensor(speed).to(device=dev, dtype=self.dtype)
        if video_noise is not None:
            video_noise = torch.as_tensor(video_noise)
        if cached:
            ids = self.core.generate_cached(latents0, text, speed, video_noise=video_noise,
                                            generator=generator, temperature=temperature,
                                            top_k=top_k)
        else:
            if temperature > 0:
                raise ValueError("temperature sampling requires cached=True")
            ids = self.core.generate(latents0, text, speed, video_noise=video_noise,
                                     generator=generator)
        video = self.first_stage.decode(ids)
        return torch.cat([first, video], dim=1)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights at the JAX package's init scales, drawn from
    ``generator``: unit norms and zero biases, Xavier-uniform convs, the
    VQ codebook U(-1/K, 1/K), width^-0.5 positional and speed embeddings,
    normal(0.02) for everything else."""

    def normal_(p, std):
        p.copy_(torch.randn(p.shape, generator=generator) * std)

    def uniform_(p, bound):
        p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * bound)

    with torch.no_grad():
        for mname, m in module.named_modules():
            for leaf, p in m.named_parameters(recurse=False):
                if isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
                    p.fill_(1.0 if leaf == "weight" else 0.0)
                elif leaf.endswith("bias"):
                    p.zero_()
                elif isinstance(m, (nn.Conv2d, nn.Conv3d)):
                    fans = (p.shape[0] + p.shape[1]) * math.prod(p.shape[2:])
                    uniform_(p, math.sqrt(6.0 / fans))
                elif mname.endswith("codebook.embedding"):
                    uniform_(p, 1.0 / p.shape[0])
                elif leaf.endswith("_embedding") and not isinstance(m, nn.Embedding):
                    normal_(p, p.shape[-1] ** -0.5)  # positional and speed
                else:
                    normal_(p, 0.02)


def build_pipeline(config_path: str | os.PathLike = "config/mage_caterv1.yaml",
                   frames_length: Optional[int] = None, *,
                   device: Optional[str | torch.device] = None,
                   seed: int = 0) -> MagePipeline:
    """``MagePipeline`` from a YAML config with random weights from ``seed``
    and no first-stage checkpoint (its ``ckpt_path`` is dropped, as the JAX
    bench does); ``frames_length`` overrides the config's clip length."""
    cfg = load_config(config_path)
    p = cfg.model.params
    p.first_stage_config.params.pop("ckpt_path", None)
    if frames_length is not None:
        p.frames_length = frames_length
        p.generate_decoder_config.params.frames_length = frames_length
    return instantiate_from_config(cfg.model, merge={"device": device, "seed": seed})
