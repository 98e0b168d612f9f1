"""The flat axial attention kernel (``csrc/axial_attention.cu``): attention
within G groups of S rows of width D, on f32 CUDA cores."""

from benchmark.counts.peaks import F32_FLOP_PER_S

TRACE_NAMES = ("axial_attention_vec", "axial_attention_scalar")


def launch(q, k, v, n_head, **_):
    return (*q.shape, n_head, q.element_size()) if q.is_cuda else None


ENTRIES = {"mage_tpu_torch.ops.axial_attention:axial_slot_attention": launch}


def count(g, s, d, heads, itemsize):
    """q, k, v in, the output out."""
    return 4 * g * s * d * itemsize, 4.0 * g * s * s * d, F32_FLOP_PER_S
