"""The VQ f8 decoder's tail (``csrc/vq_decode_tail.cu``): the last block's
3x3 conv (C -> Cout), the residual with the nearest-upsampled id path, the
ReLU, the 1x1 output conv (Cout -> O) and the tanh, on bf16 tensor cores."""

from benchmark.counts.peaks import BF16_FLOP_PER_S

TRACE_NAMES = ("vq_tail_bf16",)
F32 = 4


def count(b, h, w, c, cout, o, itemsize):
    """h (B, H, W, C) and the id path x (B, H / 2, W / 2, Cout) in, the 3x3
    and 1x1 weights and the 1x1 bias in h's dtype, the 3x3 bias in f32, the
    (B, H, W, O) frames out; the products of both convs."""
    px = b * h * w
    nbytes = ((px * c + b * (h // 2) * (w // 2) * cout + px * o + 9 * c * cout + o * cout + o)
              * itemsize + cout * F32)
    return nbytes, 2.0 * px * (9 * c + o) * cout, BF16_FLOP_PER_S


def pieces(p, mix, itemsize):
    """A bf16 generate's VQ f8 decode of its B x (L - 1) frames, at r x 8
    pixels: the last block's hidden width is dim / 4 and its output dim, O
    the frames' channels. The program launches once a chunk of up to 512
    frames; the weights count once."""
    fs = p["first_stage_config"]["params"]
    if (mix["driver"] != "generate" or not p["use_cids"] or int(fs["down_ratio"]) != 8
            or itemsize != 2):
        return []
    d, res = int(fs["dim"]), int(p["image_resolution"]) * 8
    frames = mix["batch"] * (int(p["frames_length"]) - 1)
    return [count(frames, res, res, d // 4, d, int(fs["input_dim"]), itemsize)]
