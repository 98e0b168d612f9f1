"""GroupNorm's per-(image, channel) affine rows (``csrc/gn_stats.cu``),
launched by each GroupNorm-SiLU-conv call before its conv, on f32 CUDA
cores."""

from benchmark.counts.peaks import F32_FLOP_PER_S

TRACE_NAMES = ("gn_stats_partial", "gn_stats_finish")
F32 = 4


def launch(x, gamma, beta, weight, bias, **_):
    return (*x.shape, x.element_size()) if x.is_cuda else None


ENTRIES = {"mage_tpu_torch.ops.gn_conv:gn_silu_conv3x3": launch}


def count(b, h, w, c, itemsize):
    """x in, gamma and beta in and the two rows out in f32; a multiply-add
    and an add per element."""
    return b * h * w * c * itemsize + (2 * c + 2 * b * c) * F32, 3.0 * b * h * w * c, F32_FLOP_PER_S
