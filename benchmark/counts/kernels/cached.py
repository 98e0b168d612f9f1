"""The cached-slot attention kernel (``csrc/cached_attention.cu``): N
queries over cache slots 0..pos of (L, N, D) K and V, on f32 CUDA cores."""

from benchmark.counts.kernels import decoder
from benchmark.counts.peaks import F32_FLOP_PER_S

TRACE_NAMES = ("cached_attention",)


def count(n, length, d, pos, itemsize):
    """q in, the slots up to ``pos`` of K and V in, the output out."""
    return (2 * n * d + 2 * (pos + 1) * n * d) * itemsize, 4.0 * (pos + 1) * n * d, F32_FLOP_PER_S


def pieces(p, mix, itemsize):
    """The cached sampler's temporal blocks: each, at each slot pos 0..L-1,
    attends from the B x r x r rows over slots 0..pos. The naive sampler,
    a quantized cache (plain PyTorch) and training launch none."""
    if mix["driver"] != "generate" or not mix["cached"] or mix.get("kv_quant"):
        return []
    length, r, c, _, temporal = decoder(p)
    n = mix["batch"] * r * r
    return [count(n, length, c, pos, itemsize) for pos in range(length) for _ in range(temporal)]
