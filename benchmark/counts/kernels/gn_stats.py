"""GroupNorm's per-(image, channel) affine rows (``csrc/gn_stats.cu``),
launched by each GroupNorm-SiLU-conv call before its conv, on f32 CUDA
cores."""

from benchmark.counts.kernels.gn_conv import decoder_convs, kl_decode_frames
from benchmark.counts.peaks import F32_FLOP_PER_S

TRACE_NAMES = ("gn_stats_partial", "gn_stats_finish")
F32 = 4


def count(b, h, w, c, itemsize):
    """x in, gamma and beta in and the two rows out in f32; a multiply-add
    and an add per element."""
    return b * h * w * c * itemsize + (2 * c + 2 * b * c) * F32, 3.0 * b * h * w * c, F32_FLOP_PER_S


def pieces(p, mix, itemsize):
    """The statistics of each GroupNorm-SiLU-conv call of a generate's KL
    decode (``gn_conv.pieces``), over all its frames at once."""
    frames = kl_decode_frames(p, mix)
    if not frames:
        return []
    dd = p["first_stage_config"]["params"]["ddconfig"]
    return [count(frames, res, res, cin, itemsize) for res, cin, _ in decoder_convs(dd)]
