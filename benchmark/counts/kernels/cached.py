"""The cached-slot attention kernel (``csrc/cached_attention.cu``): N
queries over cache slots 0..pos of (L, N, D) K and V, on f32 CUDA cores."""

from benchmark.counts.peaks import F32_FLOP_PER_S

TRACE_NAMES = ("cached_attention",)


def launch(q, ck, cv, pos, n_head, **_):
    return (q.shape[0], ck.shape[0], q.shape[1], int(pos), q.element_size()) if q.is_cuda \
        else None


ENTRIES = {"mage_tpu_torch.ops.cached_attention:cached_slot_attention": launch}


def count(n, length, d, pos, itemsize):
    """q in, the slots up to ``pos`` of K and V in, the output out."""
    return (2 * n * d + 2 * (pos + 1) * n * d) * itemsize, 4.0 * (pos + 1) * n * d, F32_FLOP_PER_S
