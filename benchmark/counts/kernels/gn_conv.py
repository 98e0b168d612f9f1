"""The activation pass and the 3x3 conv of one GroupNorm-SiLU-conv call
(``csrc/gn_conv.cu``): bf16 tensor cores for a bf16 call, f32 CUDA cores
for an f32 one."""

from benchmark.counts.peaks import BF16_FLOP_PER_S, F32_FLOP_PER_S

TRACE_NAMES = ("gn_act_bf16", "gn_conv_bf16", "gn_conv_f32")
F32 = 4


def count(b, h, w, c, cout, itemsize):
    """x, the weight and the output in x's dtype, the affine rows and the
    bias in f32."""
    nbytes = (b * h * w * c + b * h * w * cout + 9 * c * cout) * itemsize + (2 * b * c + cout) * F32
    peak = BF16_FLOP_PER_S if itemsize == 2 else F32_FLOP_PER_S
    return nbytes, 2.0 * b * h * w * 9 * c * cout, peak


def decoder_convs(dd: dict) -> list:
    """(resolution, C in, C out) of each GroupNorm-SiLU-conv of the KL
    decoder's resnet blocks, two a block: the middle two, then
    ``num_res_blocks`` + 1 a level from the lowest resolution up. The
    output's norm and 3-channel conv run as plain layers."""
    ch, mult, nb = int(dd["ch"]), list(dd["ch_mult"]), int(dd["num_res_blocks"])
    res = int(dd["resolution"]) // 2 ** (len(mult) - 1)
    cin = ch * mult[-1]
    blocks = [(res, cin, cin)] * 2
    for i in reversed(range(len(mult))):
        for _ in range(nb + 1):
            blocks.append((res, cin, ch * mult[i]))
            cin = ch * mult[i]
        if i:
            res *= 2
    return [conv for res, cin, cout in blocks for conv in ((res, cin, cout), (res, cout, cout))]


def kl_decode_frames(p, mix) -> int:
    """Frames the KL decode of one call takes (B x (L - 1)); 0 where there
    is none: MAGE's VQ first stage, and training, whose frozen first stage
    only encodes."""
    if mix["driver"] != "generate" or p["use_cids"]:
        return 0
    return mix["batch"] * (int(p["frames_length"]) - 1)


def pieces(p, mix, itemsize):
    """Each call of a generate's KL decode, over all its frames at once: the
    program's frame chunks each read the weight and the bias again, which
    the least time leaves out."""
    frames = kl_decode_frames(p, mix)
    if not frames:
        return []
    dd = p["first_stage_config"]["params"]["ddconfig"]
    return [count(frames, res, res, cin, cout, itemsize) for res, cin, cout in decoder_convs(dd)]
