"""Two-stage TI2V pipeline: frozen first stage + ``MAGECore``.

Port of ``mage_tpu/models/pipeline.py``. ``MagePipeline`` is built from the
same YAML ``model.params`` as the JAX class and owns both stages as
``nn.Module``s: the VQ-VAE with discrete MAGE (``use_cids: true``) or the
KL autoencoder with MAGE+. ``generate`` encodes the first frame (a posterior
sample for the KL-AE), generates the latents of the remaining frames,
decodes them and prepends the first frame. ``loss_terms`` is the training
forward: the frozen first stage encodes the clip in its own precision
without gradients, then the core's teacher-forced forward returns the raw
loss terms. The first stage never trains and always runs in eval mode.

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
from torch.func import functional_call

from mage_tpu_torch.config import instantiate_from_config, load_config, target_path
from mage_tpu_torch.models.autoencoder_kl import AutoencoderKL, DiagonalGaussian
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


# frames per KL encode or decode call: the JAX package's MAGE_KL_FRAME_CHUNK
# default, which bounds the decoder's activation memory
KL_FRAME_CHUNK = 96


class FirstStageVQVAE:
    """Frozen VQ-VAE wrapper: video-batched encode/decode. ``ckpt_path``
    names a reference VQ-VAE state dict saved with ``torch.save``, or a
    checkpoint of the port's ``VQVAETrainer`` (its model under
    ``state_dict``)."""

    is_discrete = True

    def __init__(self, model: VectorQuantizedVAE):
        self.model = model

    @classmethod
    def from_config(cls, params: Mapping[str, Any]) -> "FirstStageVQVAE":
        p = dict(params)
        ckpt_path = p.pop("ckpt_path", None)
        model = VectorQuantizedVAE(**p)
        if ckpt_path:
            sd = torch.load(ckpt_path, map_location="cpu", weights_only=True)
            model.load_state_dict(sd.get("state_dict", sd), strict=True)
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


class FirstStageKL:
    """Frozen KL-autoencoder wrapper: video-batched encode (a posterior
    sample) and decode, in frame chunks of at most ``KL_FRAME_CHUNK``
    frames."""

    is_discrete = False

    def __init__(self, model: AutoencoderKL):
        self.model = model

    @classmethod
    def from_config(cls, params: Mapping[str, Any]) -> "FirstStageKL":
        """From the ldm-style params of ``config/mage+_*.yaml``
        (``embed_dim`` and ``ddconfig``; ``monitor`` and ``lossconfig`` are
        dropped). ``ckpt_path`` names an ldm checkpoint: the state dict under
        ``state_dict``, whose ``loss.*`` training weights are dropped."""
        p = dict(params)
        p.pop("monitor", None)
        p.pop("lossconfig", None)
        ckpt_path = p.pop("ckpt_path", None)
        dd = dict(p.pop("ddconfig", {}))
        model = AutoencoderKL(
            embed_dim=p.pop("embed_dim", dd.get("z_channels", 4)),
            ch=dd.get("ch", 128),
            ch_mult=tuple(dd.get("ch_mult", (1, 2, 4, 4))),
            num_res_blocks=dd.get("num_res_blocks", 2),
            in_channels=dd.get("in_channels", 3),
            out_ch=dd.get("out_ch", 3),
            z_channels=dd.get("z_channels", 4),
            double_z=dd.get("double_z", True),
            attn_resolutions=tuple(dd.get("attn_resolutions", ())),
            resolution=dd.get("resolution", 128),
            dropout=dd.get("dropout", 0.0),
            logvar_bias=dd.get("logvar_bias", 0.0),
        )
        if ckpt_path:
            sd = torch.load(ckpt_path, map_location="cpu", weights_only=True)
            sd = sd.get("state_dict", sd)
            model.load_state_dict({k: v for k, v in sd.items() if not k.startswith("loss.")},
                                  strict=True)
        return cls(model)

    @property
    def embed_dim(self) -> int:
        return self.model.embed_dim

    @property
    def dtype(self) -> torch.dtype:
        return self.model.post_quant_conv.weight.dtype

    @torch.no_grad()
    def encode_moments(self, videos: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, C) frames -> (B, T, h, w, 2 * z) posterior moments."""
        b, t = videos.shape[:2]
        flat = videos.reshape(b * t, *videos.shape[2:]).to(self.dtype)
        moments = _chunked_frames(self.model.encode_moments, flat, KL_FRAME_CHUNK)
        return moments.reshape(b, t, *moments.shape[1:])

    @torch.no_grad()
    def encode(self, videos: torch.Tensor, noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, T, H, W, C) frames -> sampled latents (B, T, h, w, z); the
        standard-normal ``noise`` (B, T, h, w, z) is drawn from ``generator``
        when not given."""
        return DiagonalGaussian(self.encode_moments(videos)).sample(noise, generator)

    @torch.no_grad()
    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """(B, T, h, w, z) latents -> (B, T, H, W, C) frames."""
        b, t = latents.shape[:2]
        flat = latents.reshape(b * t, *latents.shape[2:]).to(self.dtype)
        frames = _chunked_frames(self.model.decode, flat, KL_FRAME_CHUNK)
        return frames.reshape(b, t, *frames.shape[1:])


def _check_target(config: Mapping, default: type, what: str) -> None:
    target = config.get("target") if isinstance(config, Mapping) else None
    if target and target_path(str(target)) != f"{default.__module__}.{default.__name__}":
        raise NotImplementedError(
            f"{what} target {target!r}: the port builds {default.__name__} only")


class MagePipeline:
    """First stage + ``MAGECore`` + loss and generation glue, from the YAML
    schema of ``config/mage_*.yaml`` and ``config/mage+_*.yaml``
    (``model.params``). ``spatial_attn="fusedblock"`` runs every eval-mode
    spatial decoder block as one fused op (the JAX package's
    ``MAGE_SPATIAL_ATTN=fusedblock``); the default ``"flat"`` runs its layers
    around the flat attention op. ``kv_quant="int8"|"int4"`` quantizes the
    cached sampler's K/V cache (the JAX package's ``MAGE_KV_QUANT``).

    The training fields are the JAX class's: ``dropout``, ``remat`` and the
    loss weights go to the core; ``alpha``, ``beta``, ``v_kl`` (the KL
    target) and ``auto_beta`` (the PID controller) to the train step."""

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
        dropout: float = 0.1,
        use_cids: bool = False,
        randomness: bool = False,
        alpha: float = 0.0,
        beta: float = 1.0,
        v_kl: float = 0.0,
        auto_beta: bool = False,
        remat: bool = False,
        motion_loss_weight: float = 0.0,
        early_loss_weight: float = 0.0,
        early_loss_frames: int = 3,
        device: Optional[str | torch.device] = None,
        seed: int = 0,
        spatial_attn: str = "flat",
        kv_quant: Optional[str] = None,
    ):
        self.device = resolve_device(device)
        self.randomness = randomness
        self.alpha = alpha
        self.beta = beta
        self.v_kl = v_kl
        self.auto_beta = auto_beta
        fs_target = target_path(str(first_stage_config.get("target", "")))
        fs_params = first_stage_config.get("params", {})
        if fs_target == f"{AutoencoderKL.__module__}.{AutoencoderKL.__name__}":
            self.first_stage = FirstStageKL.from_config(fs_params)
        else:
            _check_target(first_stage_config, VectorQuantizedVAE, "first stage")
            self.first_stage = FirstStageVQVAE.from_config(fs_params)
        _check_target(text_encoder_config, TransformerTextEncoder, "text encoder")
        _check_target(ma_config, MAEncoder, "motion-anchor encoder")
        _check_target(generate_decoder_config, FlatAxialDecoder, "decoder")
        self.use_cids = use_cids
        self.frames_length = frames_length
        te = dict(text_encoder_config.get("params", {}))
        ma = dict(ma_config.get("params", {}))
        dec = dict(generate_decoder_config.get("params", {}))
        self.core = MAGECore(
            codebook_size=codebook_size,
            frames_length=frames_length,
            image_resolution=image_resolution,
            vision_width=vision_width,
            randomness=randomness,
            use_cids=use_cids,
            pre_ln=not use_cids,  # MAGE+ uses the pre-LN cross-attention
            embed_dim=getattr(self.first_stage, "embed_dim", 4),
            dropout=dropout,
            remat=remat,
            motion_loss_weight=motion_loss_weight,
            early_loss_weight=early_loss_weight,
            early_loss_frames=early_loss_frames,
            text_vocab_size=te.get("vocab_size", 30),
            text_context_length=te.get("context_length", 32),
            text_width=te.get("transformer_width", 512),
            text_layers=te.get("transformer_layers", 2),
            text_output_dim=te.get("output_dim", 512),
            text_padding_idx=te.get("padding_idx", 0),
            text_dropout=te.get("dropout", dropout),
            ma_layers=ma.get("layers", 1),
            ma_d_model=ma.get("d_model", 512),
            dec_layers=dec.get("layers", 6),
            dec_out_channels=dec.get("out_channels", codebook_size if use_cids else 4),
            spatial_attn=spatial_attn,
            kv_quant=kv_quant,
        )
        init_weights(self.core, torch.Generator().manual_seed(seed))
        init_weights(self.first_stage.model, torch.Generator().manual_seed(seed + 1))
        self.to(self.device)
        self.core.eval()
        self.first_stage.model.eval().requires_grad_(False)

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

    # ---- training forward ------------------------------------------------------

    def encode_first_stage(self, images: torch.Tensor, noise=None,
                           generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Frames (B, T, H, W, C) -> latents, in the first stage's own dtype
        and without gradients: ids for the VQ-VAE, a posterior sample for
        the KL-AE (its standard-normal ``noise`` drawn from ``generator``
        when not given)."""
        images = torch.as_tensor(images).to(device=self.device, dtype=self.first_stage.dtype)
        if self.first_stage.is_discrete:
            return self.first_stage.encode(images)
        return self.first_stage.encode(images, noise, generator)

    def loss_terms(self, batch: Mapping[str, Any], *, train: bool = True,
                   test_flag: bool = False, params: Optional[Mapping[str, torch.Tensor]] = None,
                   compute_dtype: Optional[torch.dtype] = None,
                   generator: Optional[torch.Generator] = None,
                   posterior_noise=None, video_noise=None, first_stage_noise=None) -> dict:
        """-> the core's raw loss terms (f32 scalars), with the core in train
        mode if ``train``, else in eval mode (where its kernels run).

        ``batch`` carries ``text``, optional ``speed`` and
        ``context_latents``, and either ``images`` (encoded here by the
        frozen first stage) or precomputed ``latents``. ``params`` runs the
        core on these tensors in place of its own (the train step's bf16
        copies). ``compute_dtype`` casts the stage-2 inputs after the
        encode, so the first stage's ids do not depend on it. The noise
        arguments are ``MAGECore.forward``'s; ``first_stage_noise`` is the
        KL-AE's posterior draw."""
        dev = self.device
        self.core.train(train)
        if "latents" in batch:
            latents = torch.as_tensor(batch["latents"]).to(dev)
        else:
            latents = self.encode_first_stage(batch["images"], first_stage_noise, generator)
        speed = batch.get("speed")
        if speed is not None:
            speed = torch.as_tensor(speed).to(dev)
        context = batch.get("context_latents")
        if context is not None:
            context = torch.as_tensor(context).to(dev)
        if compute_dtype is not None:
            if latents.is_floating_point():
                latents = latents.to(compute_dtype)
            if context is not None and context.is_floating_point():
                context = context.to(compute_dtype)
            if speed is not None:
                speed = speed.to(compute_dtype)
        args = (latents, torch.as_tensor(batch["text"]).to(dev), speed)
        kwargs = dict(test_flag=test_flag, context_latents=context,
                      posterior_noise=posterior_noise, video_noise=video_noise,
                      generator=generator)
        if params is None:
            out = self.core(*args, **kwargs)
        else:
            out = functional_call(self.core, dict(params), args, kwargs)
        out.pop("predict")
        return out

    # ---- generation ------------------------------------------------------------

    @torch.no_grad()
    def generate(self, batch: Mapping[str, Any], *, video_noise=None,
                 posterior_noise=None, generator: Optional[torch.Generator] = None,
                 cached: Optional[bool] = None, temperature: float = 0.0,
                 top_k: int = 0) -> torch.Tensor:
        """batch (``images`` (B, L, H, W, C) of which frame 0 is used,
        ``text`` (B, ctx) ids, optional ``speed`` (B,)) -> video
        (B, L, H, W, C) with the given first frame prepended.

        ``video_noise`` (B, h, w, 64) is the prior sample of the stochastic
        branch and ``posterior_noise`` (B, 1, h, w, z) the standard-normal
        draw of the KL-AE's first-frame sample; what is not given is drawn
        from ``generator``. ``cached`` selects the KV-cached sampler and
        defaults to ``use_cids``: exact for discrete ids, causal GroupNorm
        statistics for MAGE+, whose default is the naive reference loop.
        ``temperature`` and ``top_k`` sample ids with the cached sampler
        instead of the greedy argmax."""
        if cached is None:
            cached = self.use_cids
        dev = self.device
        first = torch.as_tensor(batch["images"])[:, 0:1].to(device=dev,
                                                             dtype=self.first_stage.dtype)
        latents0 = self.encode_first_stage(first, posterior_noise, generator)
        if latents0.is_floating_point():
            latents0 = latents0.to(self.dtype)  # the core's dtype, as the JAX bench casts
        text = torch.as_tensor(batch["text"]).to(dev)
        speed = batch.get("speed")
        if speed is not None:
            speed = torch.as_tensor(speed).to(device=dev, dtype=self.dtype)
        if video_noise is not None:
            video_noise = torch.as_tensor(video_noise)
        if cached:
            latents = self.core.generate_cached(latents0, text, speed, video_noise=video_noise,
                                            generator=generator, temperature=temperature,
                                            top_k=top_k)
        else:
            if temperature > 0:
                raise ValueError("temperature sampling requires cached=True")
            latents = self.core.generate(latents0, text, speed, video_noise=video_noise,
                                         generator=generator)
        video = self.first_stage.decode(latents)
        return torch.cat([first, video], dim=1)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights drawn from ``generator`` from the JAX package's init
    distributions for ``module`` (a ``MAGECore``, a VQ-VAE or a KL-AE):
    unit norms and zero biases, the VQ codebook U(-1/K, 1/K), width^-0.5
    positional and speed embeddings, normal(0.02) for the other embeddings
    and the text and motion-anchor encoders' dense layers; convs and
    transposed convs Xavier-uniform (the VQ-VAE's ``_conv_init``) unless the
    model names its own ``init_conv_`` (the KL-AE: flax's LeCun normal). The
    continuous head's 1x1x1 conv (``generate_model.out.2``) starts at zero,
    as in the JAX package (the reference's ``zero_module``). A model with an
    ``init_weights(generator)`` method (``MAGECore``) then draws its own
    distributions where they differ from these."""

    def normal_(p, std):
        p.copy_(torch.randn(p.shape, generator=generator) * std)

    def uniform_(p, bound):
        p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * bound)

    def xavier_uniform_(p, _):
        uniform_(p, math.sqrt(6.0 / ((p.shape[0] + p.shape[1]) * math.prod(p.shape[2:]))))

    init_conv_ = getattr(module, "init_conv_", xavier_uniform_)
    with torch.no_grad():
        for mname, m in module.named_modules():
            for leaf, p in m.named_parameters(recurse=False):
                if isinstance(m, (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm2d)):
                    p.fill_(1.0 if leaf == "weight" else 0.0)
                elif leaf.endswith("bias") or mname.endswith("generate_model.out.2"):
                    p.zero_()
                elif isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d)):
                    init_conv_(p, generator)
                elif mname.endswith("codebook.embedding"):
                    uniform_(p, 1.0 / p.shape[0])
                elif leaf.endswith("_embedding") and not isinstance(m, nn.Embedding):
                    normal_(p, p.shape[-1] ** -0.5)  # positional and speed
                else:
                    normal_(p, 0.02)
        if hasattr(module, "init_weights"):
            module.init_weights(generator)


def build_pipeline(config_path: str | os.PathLike = "config/mage_caterv1.yaml",
                   frames_length: Optional[int] = None, *,
                   device: Optional[str | torch.device] = None,
                   seed: int = 0, spatial_attn: str = "flat",
                   dropout: Optional[float] = None,
                   kv_quant: Optional[str] = None) -> MagePipeline:
    """``MagePipeline`` from a YAML config with random weights from ``seed``
    and no first-stage checkpoint (its ``ckpt_path`` is dropped, as the JAX
    bench does); ``frames_length`` overrides the config's clip length and
    ``spatial_attn`` picks the spatial blocks' route and ``kv_quant`` the
    cache's storage (``MagePipeline``).
    ``dropout``, when given, replaces every stage-2 dropout rate of the
    config (the text encoder's too)."""
    cfg = load_config(config_path)
    p = cfg.model.params
    p.first_stage_config.params.pop("ckpt_path", None)
    if frames_length is not None:
        p.frames_length = frames_length
        p.generate_decoder_config.params.frames_length = frames_length
    if dropout is not None:
        p.dropout = dropout
        p.text_encoder_config.params.dropout = dropout
    return instantiate_from_config(cfg.model, merge={"device": device, "seed": seed,
                                                        "spatial_attn": spatial_attn,
                                                        "kv_quant": kv_quant})
