"""The activation pass and the 3x3 conv of one GroupNorm-SiLU-conv call
(``csrc/gn_conv.cu``): bf16 tensor cores for a bf16 call, f32 CUDA cores
for an f32 one."""

from benchmark.counts.peaks import BF16_FLOP_PER_S, F32_FLOP_PER_S

TRACE_NAMES = ("gn_act_bf16", "gn_conv_bf16", "gn_conv_f32")
F32 = 4


def launch(x, gamma, beta, weight, bias, **_):
    return (*x.shape, weight.shape[0], x.element_size()) if x.is_cuda else None


ENTRIES = {"mage_tpu_torch.ops.gn_conv:gn_silu_conv3x3": launch}


def count(b, h, w, c, cout, itemsize):
    """x, the weight and the output in x's dtype, the affine rows and the
    bias in f32."""
    nbytes = (b * h * w * c + b * h * w * cout + 9 * c * cout) * itemsize + (2 * b * c + cout) * F32
    peak = BF16_FLOP_PER_S if itemsize == 2 else F32_FLOP_PER_S
    return nbytes, 2.0 * b * h * w * 9 * c * cout, peak
