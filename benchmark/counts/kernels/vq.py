"""The nearest-code search (``csrc/vq.cu``): bf16 tensor cores for its
bf16 variant, f32 CUDA cores for the f32 (SIMT) one."""

from benchmark.counts.peaks import BF16_FLOP_PER_S, F32_FLOP_PER_S

TRACE_NAMES = ("vq_wgmma", "vq_simt", "vq_finish", "codebook_sqnorm")
F32 = 4


def count(n, k, d, itemsize, with_codes):
    """Tokens and codebook in, ids (and the codes, when gathered) out."""
    nbytes = (n * d + k * d) * itemsize + n * F32 + (n * d * itemsize if with_codes else 0)
    return nbytes, 2.0 * n * k * d, BF16_FLOP_PER_S if itemsize == 2 else F32_FLOP_PER_S


def pieces(p, mix, itemsize):
    """MAGE's VQ first stage searches its K codes of width dim (f4) or 4 x
    dim (f8) for ids only: in a generate, the r x r tokens of each clip's
    first frame; in a train step, the frozen encode's, of all L frames."""
    if not p["use_cids"]:
        return []
    fs = p["first_stage_config"]["params"]
    width = int(fs["dim"]) * (1 if int(fs["down_ratio"]) == 4 else 4)
    frames = 1 if mix["driver"] == "generate" else int(p["frames_length"])
    rows = mix["batch"] * frames * int(p["image_resolution"]) ** 2
    return [count(rows, int(fs["K"]), width, itemsize, False)]
