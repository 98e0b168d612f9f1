"""The flat axial attention kernel (``csrc/axial_attention.cu``): attention
within G groups of S rows of width D, on f32 CUDA cores."""

from benchmark.counts.kernels import decoder
from benchmark.counts.peaks import F32_FLOP_PER_S

TRACE_NAMES = ("axial_attention_vec", "axial_attention_scalar")


def count(g, s, d, heads, itemsize):
    """q, k, v in, the output out."""
    return 4 * g * s * d * itemsize, 4.0 * g * s * s * d, F32_FLOP_PER_S


def pieces(p, mix, itemsize):
    """A generate's spatial (H and W) blocks on the flat route, C / 32 heads.
    The cached sampler runs each on one slot at a time, for the L slots (the
    anchor and L - 1 frames), over B x r groups of r rows; the naive one
    runs the whole decoder over the L slots for each of the L - 1 frames.
    The fused-block route and training (plain layers) launch none."""
    if mix["driver"] != "generate" or mix.get("spatial_attn", "flat") != "flat":
        return []
    length, r, c, layers, temporal = decoder(p)
    b, spatial = mix["batch"], layers - temporal
    if mix["cached"]:
        return [count(b * r, r, c, c // 32, itemsize)] * (length * spatial)
    return [count(b * length * r, r, c, c // 32, itemsize)] * ((length - 1) * spatial)
