"""Carry weights from ``mage_tpu`` parameter trees into the port.

The port's own numpy-only copy of the JAX package's export logic
(``mage_tpu/compat/torch_export.py``): JAX parameter trees, given as nested
dicts of numpy arrays, become state dicts in the reference PyTorch layout,
which is the layout of the port's modules (NHWC flax kernels -> NCHW torch,
DenseGeneral q/k/v -> packed ``in_proj``, flax BatchNorm statistics ->
running buffers, and so on). It covers the f4 and f8 VQ-VAE, ``MAGECore``
for MAGE (``use_cids=True``, ``pre_ln=False``, whose
``ln_q``/``ln_kv`` are emitted as identity) and MAGE+ (``use_cids=False``,
``pre_ln=True``: the continuous head, the latent projection and real
``ln_q``/``ln_kv``), and the KL autoencoder (``export_autoencoder_kl``, to the
ldm keys; the JAX package has no exporter for it), and the I3D feature
network (``export_i3d``, to piergiaj/pytorch-i3d's keys: the inverse of
the JAX package's ``import_i3d_torch``).

``load`` and ``load_pipeline`` strict-load the result into the port's modules.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch


def _np(x) -> np.ndarray:
    return np.asarray(x)


def conv2d_weight(kernel) -> np.ndarray:
    """(kH, kW, I, O) -> (O, I, kH, kW)."""
    return _np(kernel).transpose(3, 2, 0, 1)


def conv3d_weight(kernel) -> np.ndarray:
    """(kT, kH, kW, I, O) -> (O, I, kT, kH, kW)."""
    return _np(kernel).transpose(4, 3, 0, 1, 2)


def convtranspose2d_weight(kernel) -> np.ndarray:
    """(kH, kW, O, I) of a flax ``transpose_kernel=True`` kernel -> (I, O, kH, kW)."""
    return _np(kernel).transpose(3, 2, 0, 1)


def linear_weight(kernel) -> np.ndarray:
    """(I, O) -> (O, I)."""
    return _np(kernel).T


def merge_in_proj(q, k, v) -> tuple[np.ndarray, np.ndarray]:
    """Three (D, heads, hd) DenseGeneral kernels (+ (heads, hd) biases) ->
    packed (3D, D) in_proj_weight and (3D,) in_proj_bias."""
    ws, bs = [], []
    for p in (q, k, v):
        kern = _np(p["kernel"])
        ws.append(kern.reshape(kern.shape[0], -1).T)
        bs.append(_np(p["bias"]).reshape(-1))
    return np.concatenate(ws, axis=0), np.concatenate(bs, axis=0)


def out_proj_weight(kernel) -> np.ndarray:
    """(heads, hd, D) -> (D, D)."""
    kern = _np(kernel)
    return kern.reshape(-1, kern.shape[-1]).T


def to_torch(sd: Mapping[str, np.ndarray]) -> dict:
    """numpy state dict -> CPU torch tensors (copied: JAX buffers are read-only)."""
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _put_conv(sd, prefix, params, kind="conv2d"):
    fn = {"conv2d": conv2d_weight, "convT": convtranspose2d_weight,
          "linear": linear_weight}[kind]
    sd[f"{prefix}.weight"] = fn(params["kernel"])
    if "bias" in params:
        sd[f"{prefix}.bias"] = _np(params["bias"])


def _put_bottleneck(sd, prefix, params, has_id_path):
    convs = [params[f"Conv_{i}"] for i in range(4 + has_id_path)]
    if has_id_path:
        _put_conv(sd, f"{prefix}.id_path", convs[0])
        convs = convs[1:]
    for conv, t in zip(convs, (1, 3, 5, 7)):
        _put_conv(sd, f"{prefix}.block.{t}", conv)


def _put_bn(sd, prefix, params, stats):
    sd[f"{prefix}.weight"] = _np(params["scale"])
    sd[f"{prefix}.bias"] = _np(params["bias"])
    sd[f"{prefix}.running_mean"] = _np(stats["mean"])
    sd[f"{prefix}.running_var"] = _np(stats["var"])
    sd[f"{prefix}.num_batches_tracked"] = np.asarray(0, np.int64)


def _put_resblock(sd, prefix, params, stats):
    _put_conv(sd, f"{prefix}.block.1", params["Conv_0"])
    _put_bn(sd, f"{prefix}.block.2", params["BatchNorm_0"], stats["BatchNorm_0"])
    _put_conv(sd, f"{prefix}.block.4", params["Conv_1"])
    _put_bn(sd, f"{prefix}.block.5", params["BatchNorm_1"], stats["BatchNorm_1"])


def export_vqvae(variables: Mapping[str, Any], down_ratio: int) -> dict:
    """{params, batch_stats} of a ``VectorQuantizedVAE`` with this
    ``down_ratio`` (4 or 8) -> reference state dict."""
    params = variables["params"]
    enc, dec = params["encoder"], params["decoder"]
    sd: dict = {"codebook.embedding.weight": _np(params["codebook"])}
    if down_ratio == 4:
        stats = variables["batch_stats"]
        enc_s, dec_s = stats["encoder"], stats["decoder"]
        _put_conv(sd, "encoder.0", enc["Conv_0"])
        _put_bn(sd, "encoder.1", enc["BatchNorm_0"], enc_s["BatchNorm_0"])
        _put_conv(sd, "encoder.3", enc["Conv_1"])
        for side, p, s, first in (("encoder", enc, enc_s, 4), ("decoder", dec, dec_s, 0)):
            for i in range(2):
                _put_resblock(sd, f"{side}.{first + i}", p[f"ResBlock_{i}"], s[f"ResBlock_{i}"])
        _put_conv(sd, "decoder.3", dec["ConvTranspose_0"], "convT")
        _put_bn(sd, "decoder.4", dec["BatchNorm_0"], dec_s["BatchNorm_0"])
        _put_conv(sd, "decoder.6", dec["ConvTranspose_1"], "convT")
    elif down_ratio == 8:
        _put_conv(sd, "encoder.0", enc["Conv_0"])
        for i, (t, chg) in enumerate(zip((1, 3, 5, 7), (False, False, True, True))):
            _put_bottleneck(sd, f"encoder.{t}", enc[f"EncoderBlock_{i}"], chg)
        for i, (t, chg) in enumerate(zip((0, 2, 4, 6), (True, True, False, False))):
            _put_bottleneck(sd, f"decoder.{t}", dec[f"DecoderBlock_{i}"], chg)
        _put_conv(sd, "decoder.8", dec["Conv_0"])
    else:
        raise ValueError(f"unsupported down_ratio {down_ratio}")
    return sd


def _put_ln(sd, prefix, params):
    sd[f"{prefix}.weight"] = _np(params["scale"])
    sd[f"{prefix}.bias"] = _np(params["bias"])


def _put_identity_ln(sd, prefix, dim):
    sd[f"{prefix}.weight"] = np.ones((dim,), np.float32)
    sd[f"{prefix}.bias"] = np.zeros((dim,), np.float32)


def _put_mha(sd, prefix, params):
    w, b = merge_in_proj(params["q_proj"], params["k_proj"], params["v_proj"])
    sd[f"{prefix}.in_proj_weight"] = w
    sd[f"{prefix}.in_proj_bias"] = b
    sd[f"{prefix}.out_proj.weight"] = out_proj_weight(params["out_proj"]["kernel"])
    sd[f"{prefix}.out_proj.bias"] = _np(params["out_proj"]["bias"])


def _put_mlp(sd, prefix, params):
    _put_conv(sd, f"{prefix}.c_fc", params["c_fc"], "linear")
    _put_conv(sd, f"{prefix}.c_proj", params["c_proj"], "linear")


def export_axial_block(params: Mapping[str, Any], prefix: str = "") -> dict:
    """``AxialAttentionBlock`` params -> state dict (keys under ``prefix``)."""
    sd: dict = {}
    p = f"{prefix}." if prefix else ""
    _put_mha(sd, f"{p}attn", params["attn"])
    _put_ln(sd, f"{p}ln_1", params["ln_1"])
    _put_ln(sd, f"{p}ln_2", params["ln_2"])
    _put_mlp(sd, f"{p}mlp", params["mlp"])
    return sd


def _put_cross_block(sd, prefix, params, pre_ln):
    _put_mha(sd, f"{prefix}.attn", params["attn"])
    _put_ln(sd, f"{prefix}.ln_2", params["ln_2"])
    _put_mlp(sd, f"{prefix}.mlp", params["mlp"])
    if pre_ln:
        _put_ln(sd, f"{prefix}.ln_q", params["ln_q"])
        _put_ln(sd, f"{prefix}.ln_kv", params["ln_kv"])
    else:
        dim = _np(params["attn"]["out_proj"]["bias"]).shape[0]
        _put_identity_ln(sd, f"{prefix}.ln_q", dim)
        _put_identity_ln(sd, f"{prefix}.ln_kv", dim)


def export_text_encoder(te: Mapping[str, Any], text_layers: int,
                        prefix: str = "text_encoder") -> dict:
    sd: dict = {}
    p = f"{prefix}." if prefix else ""
    sd[f"{p}token_embedding.weight"] = _np(te["token_embedding"]["embedding"])
    sd[f"{p}positions.weight"] = _np(te["positions"]["embedding"])
    _put_ln(sd, f"{p}layer_norm", te["layer_norm"])
    _put_ln(sd, f"{p}ln_text_final", te["ln_text_final"])
    _put_conv(sd, f"{p}text_projection", te["text_projection"], "linear")
    for i in range(text_layers):
        lp = f"{p}transformer.layers.{i}"
        layer = te[f"layer_{i}"]
        _put_mha(sd, f"{lp}.self_attn", layer["self_attn"])
        _put_ln(sd, f"{lp}.norm1", layer["norm1"])
        _put_ln(sd, f"{lp}.norm2", layer["norm2"])
        _put_conv(sd, f"{lp}.linear1", layer["linear1"], "linear")
        _put_conv(sd, f"{lp}.linear2", layer["linear2"], "linear")
    return sd


def export_bert_text_head(te: Mapping[str, Any], prefix: str = "text_encoder") -> dict:
    """A JAX ``BertTextualHead``'s params (``FlaxBertModule`` under ``bert``
    and ``text_projection_key``) -> HF torch ``BertModel`` keys under
    ``{prefix}.bert.``, plus ``{prefix}.text_projection_key``."""
    sd: dict = {}
    p = f"{prefix}." if prefix else ""
    bert = te["bert"]
    emb = bert["embeddings"]
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        sd[f"{p}bert.embeddings.{name}.weight"] = _np(emb[name]["embedding"])
    _put_ln(sd, f"{p}bert.embeddings.LayerNorm", emb["LayerNorm"])
    for i, layer in bert["encoder"]["layer"].items():
        lp = f"{p}bert.encoder.layer.{i}"
        att = layer["attention"]
        for name in ("query", "key", "value"):
            _put_conv(sd, f"{lp}.attention.self.{name}", att["self"][name], "linear")
        _put_conv(sd, f"{lp}.attention.output.dense", att["output"]["dense"], "linear")
        _put_ln(sd, f"{lp}.attention.output.LayerNorm", att["output"]["LayerNorm"])
        _put_conv(sd, f"{lp}.intermediate.dense", layer["intermediate"]["dense"], "linear")
        _put_conv(sd, f"{lp}.output.dense", layer["output"]["dense"], "linear")
        _put_ln(sd, f"{lp}.output.LayerNorm", layer["output"]["LayerNorm"])
    _put_conv(sd, f"{p}bert.pooler.dense", bert["pooler"]["dense"], "linear")
    sd[f"{p}text_projection_key"] = _np(te["text_projection_key"])
    return sd


def export_ma_encoder(ma: Mapping[str, Any], ma_layers: int,
                      prefix: str = "ma_encoder", pre_ln: bool = False) -> dict:
    sd: dict = {}
    p = f"{prefix}." if prefix else ""
    for i in range(ma_layers):
        _put_cross_block(sd, f"{p}blocks.{i}", ma[f"block_{i}"], pre_ln)
    return sd


def export_adain(adain: Mapping[str, Any], prefix: str = "adain") -> dict:
    sd: dict = {}
    p = f"{prefix}." if prefix else ""
    _put_conv(sd, f"{p}conv_mu.0", adain["conv_mu_0"])
    _put_conv(sd, f"{p}conv_mu.1", adain["conv_mu_1"])
    _put_conv(sd, f"{p}conv_var.0", adain["conv_var_0"])
    _put_conv(sd, f"{p}conv_var.1", adain["conv_var_1"])
    return sd


def _put_basic_block3d(sd, prefix, params, stats=None):
    sd[f"{prefix}.conv1.weight"] = conv3d_weight(params["conv1"]["kernel"])
    _put_ln(sd, f"{prefix}.bn1", params["bn1"])
    sd[f"{prefix}.conv2.weight"] = conv3d_weight(params["conv2"]["kernel"])
    _put_ln(sd, f"{prefix}.bn2", params["bn2"])
    if "downsample_conv" in params:
        sd[f"{prefix}.downsample.0.weight"] = conv3d_weight(
            params["downsample_conv"]["kernel"])
        _put_ln(sd, f"{prefix}.downsample.1", params["downsample_norm"])
    # a spectral block's power-iteration state: flax keeps it in batch_stats
    # under SpectralNorm_{i} as ``conv{i+1}/kernel/u`` and ``.../sigma``
    for i, conv in enumerate(("conv1", "conv2")):
        sn = (stats or {}).get(f"SpectralNorm_{i}")
        if sn is not None:
            sd[f"{prefix}.{conv}.u"] = _np(sn[f"{conv}/kernel/u"])
            sd[f"{prefix}.{conv}.sigma"] = _np(sn[f"{conv}/kernel/sigma"])


def export_basic_block3d(variables: Mapping[str, Any], prefix: str = "") -> dict:
    """``{params[, batch_stats]}`` of a JAX ``BasicBlock3D`` -> the port's
    state dict; a spectral block's ``u`` and ``sigma`` come with it."""
    sd: dict = {}
    _put_basic_block3d(sd, prefix, variables["params"], variables.get("batch_stats"))
    return {k.lstrip("."): v for k, v in sd.items()}


def export_mage_core(params: Mapping[str, Any], *, randomness: bool, text_layers: int,
                     ma_layers: int, dec_layers: int, use_cids: bool = True,
                     pre_ln: bool = False,
                     first_stage: Mapping[str, np.ndarray] | None = None) -> dict:
    """``MAGECore`` params -> reference MAGE state dict; ``first_stage``
    (from :func:`export_vqvae` or :func:`export_autoencoder_kl`) is merged
    under ``first_stage_model.``."""
    sd: dict = {}
    te = params["text_encoder"]
    if "bert" in te:
        sd.update(export_bert_text_head(te))
    else:
        sd.update(export_text_encoder(te, text_layers))
    sd.update(export_ma_encoder(params["ma_encoder"], ma_layers, pre_ln=pre_ln))
    gm = params["generate_model"]
    _put_conv(sd, "generate_model.in_linear", gm["in_linear"], "linear")
    _put_conv(sd, "generate_model.context_linear", gm["context_linear"], "linear")
    sd["generate_model.T_positional_embedding"] = _np(gm["T_positional_embedding"])
    for i in range(dec_layers):
        sd.update(export_axial_block(gm[f"blocks_{i}"], f"generate_model.blocks.{i}"))
    if use_cids:
        _put_conv(sd, "generate_model.out", gm["out"], "linear")
    else:
        _put_ln(sd, "generate_model.out.0", gm["out_norm"])
        kern = _np(gm["out_conv"]["kernel"])  # (I, O) Dense == 1x1x1 conv3d
        sd["generate_model.out.2.weight"] = kern.T[..., None, None, None]
        sd["generate_model.out.2.bias"] = _np(gm["out_conv"]["bias"])
    sd["conv.0.weight"] = conv2d_weight(params["conv"]["kernel"])
    sd["speed_embedding"] = _np(params["speed_embedding"])
    sd["H_positional_embedding"] = _np(params["H_positional_embedding"])[None]
    sd["W_positional_embedding"] = _np(params["W_positional_embedding"])[None]
    if use_cids:
        sd["visual_token_embedding.weight"] = _np(
            params["visual_token_embedding"]["embedding"])
    else:
        _put_conv(sd, "visual_token_embedding", params["visual_token_projection"], "linear")
    if randomness:
        for i in range(4):
            _put_basic_block3d(sd, f"conv3d.{i}", params[f"conv3d_{i}"])
        _put_conv(sd, "conv_mu2", params["conv_mu2"])
        _put_conv(sd, "conv_var2", params["conv_var2"])
        sd["conv_d2.weight"] = conv2d_weight(params["conv_d2"]["kernel"])
        sd.update(export_adain(params["adain"]))
    if first_stage is not None:
        for k, v in first_stage.items():
            sd[f"first_stage_model.{k}"] = v
    return sd


def _put_kl_resnet(sd, prefix, params):
    for name in ("norm1", "norm2"):
        _put_ln(sd, f"{prefix}.{name}", params[name])
    for name in ("conv1", "conv2", "nin_shortcut"):
        if name in params:
            _put_conv(sd, f"{prefix}.{name}", params[name])


def _put_kl_attn(sd, prefix, params):
    _put_ln(sd, f"{prefix}.norm", params["norm"])
    for name in ("q", "k", "v", "proj_out"):
        _put_conv(sd, f"{prefix}.{name}", params[name])


_KL_MID = {"mid_block_1": "mid.block_1", "mid_attn": "mid.attn_1",
           "mid_block_2": "mid.block_2"}


def _kl_key(name: str) -> str:
    """flax module name -> ldm key: ``down_0_block_1`` -> ``down.0.block.1``,
    ``up_2_upsample`` -> ``up.2.upsample.conv``, ``mid_attn`` -> ``mid.attn_1``."""
    m = re.fullmatch(r"(down|up)_(\d+)_(block|attn)_(\d+)", name)
    if m:
        return f"{m[1]}.{m[2]}.{m[3]}.{m[4]}"
    m = re.fullmatch(r"(down|up)_(\d+)_(downsample|upsample)", name)
    if m:
        return f"{m[1]}.{m[2]}.{m[3]}.conv"
    return _KL_MID.get(name, name)


def export_autoencoder_kl(variables: Mapping[str, Any]) -> dict:
    """{params} of a JAX ``AutoencoderKL`` -> ldm ``AutoencoderKL`` state dict
    (``encoder.down.{i}.block.{j}.conv1.weight``, ``decoder.mid.attn_1.q``,
    ``quant_conv``, ...), the layout of the port's ``AutoencoderKL``."""
    params = variables["params"]
    sd: dict = {}
    for side in ("encoder", "decoder"):
        for name, p in params[side].items():
            key = f"{side}.{_kl_key(name)}"
            if "norm1" in p:
                _put_kl_resnet(sd, key, p)
            elif "proj_out" in p:
                _put_kl_attn(sd, key, p)
            elif name.endswith("sample"):
                _put_conv(sd, key, p["conv"])
            elif "scale" in p:
                _put_ln(sd, key, p)
            else:
                _put_conv(sd, key, p)
    _put_conv(sd, "quant_conv", params["quant_conv"])
    _put_conv(sd, "post_quant_conv", params["post_quant_conv"])
    return sd


def export_i3d(variables: Mapping[str, Any]) -> dict:
    """JAX I3D variables ``{params, batch_stats}`` -> a pytorch-i3d state
    dict (``Conv3d_1a_7x7.conv3d.weight``, ``Mixed_3b.b1a.bn.running_var``,
    ``logits.conv3d.bias``, ...), the layout of ``mage_tpu_torch.evals.i3d``.
    Every BatchNorm also gets pytorch-i3d's ``num_batches_tracked`` (0),
    which the JAX importer drops."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd: dict = {}

    def put_unit(prefix, p, s):
        sd[f"{prefix}.conv3d.weight"] = conv3d_weight(p["conv3d"]["kernel"])
        if "bias" in p["conv3d"]:
            sd[f"{prefix}.conv3d.bias"] = _np(p["conv3d"]["bias"])
        if "bn" in p:
            sd[f"{prefix}.bn.weight"] = _np(p["bn"]["scale"])
            sd[f"{prefix}.bn.bias"] = _np(p["bn"]["bias"])
            sd[f"{prefix}.bn.running_mean"] = _np(s["bn"]["mean"])
            sd[f"{prefix}.bn.running_var"] = _np(s["bn"]["var"])
            sd[f"{prefix}.bn.num_batches_tracked"] = np.array(0, np.int64)

    for name, p in params.items():
        if name.startswith("Mixed"):
            for branch, bp in p.items():
                put_unit(f"{name}.{branch}", bp, stats.get(name, {}).get(branch, {}))
        else:
            put_unit(name, p, stats.get(name, {}))
    return sd


def load(module: torch.nn.Module, sd: Mapping[str, np.ndarray]) -> torch.nn.Module:
    """Strict-load a numpy state dict into ``module`` (values are copied into
    its parameters, keeping their device and dtype)."""
    module.load_state_dict(to_torch(sd), strict=True)
    return module


def load_pipeline(pipeline, params: Mapping[str, Any], fs_variables: Mapping[str, Any],
                  *, text_layers: int, ma_layers: int, dec_layers: int):
    """Strict-load a JAX ``MagePipeline``'s core params and first-stage
    variables (VQ-VAE or KL-AE, by the port's first-stage type) into the
    port's ``MagePipeline``."""
    fs_model = pipeline.first_stage.model
    if pipeline.first_stage.is_discrete:
        first_stage = export_vqvae(fs_variables, fs_model.down_ratio)
    else:
        first_stage = export_autoencoder_kl(fs_variables)
    core = pipeline.core
    sd = export_mage_core(params, randomness=core.randomness, text_layers=text_layers,
                          ma_layers=ma_layers, dec_layers=dec_layers,
                          use_cids=core.use_cids, pre_ln=core.pre_ln,
                          first_stage=first_stage)
    pipeline.load_state_dict(to_torch(sd))
    return pipeline
