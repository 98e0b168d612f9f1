"""The nearest-code search (``csrc/vq.cu``): bf16 tensor cores for its
bf16 variant, f32 CUDA cores for the f32 (SIMT) one."""

from benchmark.counts.peaks import BF16_FLOP_PER_S, F32_FLOP_PER_S

TRACE_NAMES = ("vq_wgmma", "vq_simt", "vq_finish", "codebook_sqnorm")
F32 = 4


def _launch(with_codes):
    def launch(z, codebook, **_):
        n = z.numel() // z.shape[-1]
        return (n, *codebook.shape, z.element_size(), with_codes) if z.is_cuda else None
    return launch


ENTRIES = {"mage_tpu_torch.ops.vq:nearest_codebook_indices": _launch(False),
           "mage_tpu_torch.ops.vq:nearest_with_codes": _launch(True)}


def count(n, k, d, itemsize, with_codes):
    """Tokens and codebook in, ids (and the codes, when gathered) out."""
    nbytes = (n * d + k * d) * itemsize + n * F32 + (n * d * itemsize if with_codes else 0)
    return nbytes, 2.0 * n * k * d, BF16_FLOP_PER_S if itemsize == 2 else F32_FLOP_PER_S
