"""FLOPs of a whole generate and of a train step, from the configuration's
shapes: two per multiply-add of every matrix product and convolution the
published model computes (normalisations, activations and softmax left out, as
``torch.utils.flop_counter`` leaves them out). The first stage follows the
published layers: the VQ-VAE decoder upsamples before each of its last
three blocks, the KL decoder upsamples and then convolves.

``temporal="cached"`` is the cached sampler's work: slot p of a causal
temporal block attends over p + 1 slots. ``"full"`` is a teacher-forced
pass over every slot, its masked scores computed too (what the reference
runs, and what the CPU test holds against ``FlopCounterMode``)."""

from __future__ import annotations

from typing import Mapping


def conv(res: int, cin: int, cout: int, k: int) -> float:
    """A k x k conv producing res x res outputs."""
    return 2.0 * res * res * cin * cout * k * k


def _vq_bottleneck(res, cin, cout, decoder: bool) -> float:
    hid = cout // 4
    f = conv(res, cin, cout, 1) if cin != cout else 0.0
    if decoder:  # 1x1 in, then three 3x3
        return f + conv(res, cin, hid, 1) + 2 * conv(res, hid, hid, 3) + conv(res, hid, cout, 3)
    return f + conv(res, cin, hid, 3) + 2 * conv(res, hid, hid, 3) + conv(res, hid, cout, 1)


def vq_encode(fs: Mapping, res: int) -> float:
    """One frame through the f8 encoder and the nearest-code search."""
    d, k = int(fs["dim"]), int(fs["K"])
    f = conv(res, int(fs["input_dim"]), d, 7)
    for r, cin, cout in ((res, d, d), (res // 2, d, d), (res // 4, d, 2 * d),
                         (res // 8, 2 * d, 4 * d)):
        f += _vq_bottleneck(r, cin, cout, decoder=False)
    return f + 2.0 * (res // 8) ** 2 * k * 4 * d


def vq_decode(fs: Mapping, res: int) -> float:
    d = int(fs["dim"])
    f = 0.0
    for r, cin, cout in ((res // 8, 4 * d, 2 * d), (res // 4, 2 * d, d), (res // 2, d, d),
                         (res, d, d)):
        f += _vq_bottleneck(r, cin, cout, decoder=True)
    return f + conv(res, d, int(fs["input_dim"]), 1)


def _resnet(res, cin, cout) -> float:
    return conv(res, cin, cout, 3) + conv(res, cout, cout, 3) + (
        conv(res, cin, cout, 1) if cin != cout else 0.0)


def _kl_mid(res, c) -> float:
    attn = 4 * conv(res, c, c, 1) + 2 * 2.0 * (res * res) ** 2 * c
    return 2 * _resnet(res, c, c) + attn


def kl_encode(dd: Mapping) -> float:
    """One frame through the KL encoder and its moments' 1x1 conv."""
    ch, mult, nb = int(dd["ch"]), list(dd["ch_mult"]), int(dd["num_res_blocks"])
    res, z2 = int(dd["resolution"]), 2 * int(dd["z_channels"])
    f = conv(res, int(dd["in_channels"]), ch, 3)
    cin = ch
    for i, m in enumerate(mult):
        for _ in range(nb):
            f += _resnet(res, cin, ch * m)
            cin = ch * m
        if i != len(mult) - 1:
            res //= 2
            f += conv(res, cin, cin, 3)
    return f + _kl_mid(res, cin) + conv(res, cin, z2, 3) + conv(res, z2, z2, 1)


def kl_decode(dd: Mapping) -> float:
    ch, mult, nb = int(dd["ch"]), list(dd["ch_mult"]), int(dd["num_res_blocks"])
    z = int(dd["z_channels"])
    res = int(dd["resolution"]) // 2 ** (len(mult) - 1)
    cin = ch * mult[-1]
    f = conv(res, z, z, 1) + conv(res, z, cin, 3) + _kl_mid(res, cin)
    for i in reversed(range(len(mult))):
        for _ in range(nb + 1):
            f += _resnet(res, cin, ch * mult[i])
            cin = ch * mult[i]
        if i != 0:
            res *= 2
            f += conv(res, cin, cin, 3)
    return f + conv(res, cin, int(dd["out_ch"]), 3)


def text_encoder(te: Mapping) -> float:
    """One caption of ``context_length`` tokens."""
    t, w = int(te["context_length"]), int(te["transformer_width"])
    layer = 2.0 * t * w * 4 * w + 4.0 * t * t * w + 2.0 * t * w * 8 * w
    return te["transformer_layers"] * layer + 2.0 * t * w * int(te["output_dim"])


def _core(p: Mapping, temporal: str) -> tuple:
    """One clip through stage 2, teacher-forced or cached -> (FLOPs, the
    speed embedding's product alone)."""
    length, r, c = int(p["frames_length"]), int(p["image_resolution"]), int(p["vision_width"])
    te = p["text_encoder_config"]["params"]
    fs = p["first_stage_config"]["params"]
    n_ma = int(p["ma_config"]["params"]["layers"])
    n_dec = int(p["generate_decoder_config"]["params"]["layers"])
    tok = r * r
    if p["use_cids"]:
        embed, head = 0.0, 2.0 * tok * c * int(p["codebook_size"])
    else:
        z = int(fs["embed_dim"])
        embed, head = 2.0 * tok * z * c, 2.0 * tok * c * z
    ctx = int(te["context_length"])
    ma = n_ma * (4.0 * tok * c * c + 4.0 * ctx * c * c + 4.0 * tok * ctx * c + 16.0 * tok * c * c)
    prior = conv(r, 64, c, 3) + 4 * conv(r, c, c, 3) if p.get("randomness") else 0.0
    speed = 2.0 * c
    anchor = text_encoder(te) + ma + prior + speed
    frames = length - 1
    stem = frames * (conv(r, c, c, 3) + embed)
    slots = length  # the anchor and the frames fed in
    linear = slots * 2.0 * tok * c * c + n_dec * slots * tok * 24.0 * c * c
    n_t = len(range(0, n_dec, 3))
    pairs = length * (length + 1) / 2 if temporal == "cached" else length * length
    attn = n_t * tok * 4.0 * c * pairs + (n_dec - n_t) * slots * tok * 4.0 * r * c
    return stem + anchor + linear + attn + frames * head, speed


def posterior(p: Mapping) -> float:
    """One clip's posterior: the 3D-conv pyramid over its L frames (each
    block's two convs and its strided skip conv; stride 2 along T) and the
    two 3x3 convs of its moments."""
    length, r, c = int(p["frames_length"]), int(p["image_resolution"]), int(p["vision_width"])
    d = int(p["ma_config"]["params"]["d_model"])
    f, t = 0.0, length
    for cout in (c, c, c, d):
        t = (t - 1) // 2 + 1
        f += 2.0 * t * r * r * 27 * (c * cout + cout * cout + c * cout)
    return f + 2 * conv(r, d, 64, 3)


def first_stage_encode(p: Mapping) -> float:
    fs = p["first_stage_config"]["params"]
    if p["use_cids"]:
        return vq_encode(fs, int(p["image_resolution"]) * int(fs["down_ratio"]))
    return kl_encode(fs["ddconfig"])


def train_step(p: Mapping, batch: int) -> float:
    """One stage-2 train step of ``batch`` clips: the frozen encode of every
    frame, and stage 2's teacher-forced forward (the posterior and the
    speed regulariser's product included) and its backward, which computes
    two products for each forward one, one for the speed embedding's
    (the speed takes no gradient)."""
    length = int(p["frames_length"])
    core, speed = _core(p, "full")
    forward = core + posterior(p) + speed  # the regulariser's own product
    return batch * (length * first_stage_encode(p) + 3 * forward - 2 * speed)


def generate(p: Mapping, batch: int, temporal: str = "cached") -> float:
    """One generate of ``batch`` clips from ``model.params`` ``p``: the
    first-frame encode, the prior branch and motion anchor, the decoder over
    the anchor slot and L - 1 frame slots, the head on L - 1 slots and the
    decode of L - 1 frames a clip."""
    length, r = int(p["frames_length"]), int(p["image_resolution"])
    fs = p["first_stage_config"]["params"]
    if p["use_cids"]:
        decode = vq_decode(fs, r * int(fs["down_ratio"]))
    else:
        decode = kl_decode(fs["ddconfig"])
    return batch * (first_stage_encode(p) + _core(p, temporal)[0] + (length - 1) * decode)
