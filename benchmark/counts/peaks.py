"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W
limit); a share is stated against these with the card's power limit beside."""

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12  # tensor cores, bf16 and fp16
F32_FLOP_PER_S = 67e12  # CUDA cores, no tensor cores


def least_seconds(nbytes: float, ops: float, flop_per_s: float) -> tuple:
    """(the least time the chip could take, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / flop_per_s
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
