"""The VQ-VAE f8 decoder's fused tail (``ops.vq_tail``) on the CPU: its plain
version against the layer chain it replaces, and the route in
``VectorQuantizedVAE.decode`` that takes it (bf16, f8, autograd off, on the
card). The kernel itself is held to the plain version on the card in
``test_torch_port_kernels.py``. Also the upsampling ``DecoderBlock`` against
the chain that computes its upsamples with ``F.interpolate``.
"""

import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from mage_tpu_torch.models import vqvae
from mage_tpu_torch.models.pipeline import FirstStageVQVAE
from mage_tpu_torch.ops import codebook_lookup, vq_tail


def _model(dim: int, input_dim: int = 3, down_ratio: int = 8, seed: int = 0):
    torch.manual_seed(seed)
    model = vqvae.VectorQuantizedVAE(input_dim=input_dim, down_ratio=down_ratio, dim=dim, K=16)
    for p in model.parameters():  # weights of the size a trained decoder has
        p.data.normal_(0.0, 0.5 / max(1, p[0].numel()) ** 0.5)
    return model.eval()


def _chain(model, h, x):
    """``block[6]`` ... ``decoder[9]`` on NHWC h and x, as the layer chain
    runs them."""
    last = model.decoder[6]
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
    y = y + last.block[6:](h.permute(0, 3, 1, 2))
    return model.decoder[7:](y).permute(0, 2, 3, 1)


def _tail_args(model):
    last, out = model.decoder[6], model.decoder[8]
    return last.block[7].weight, last.block[7].bias, out.weight, out.bias


@pytest.mark.parametrize("dim,input_dim,b,hh,ww", [
    (256, 3, 2, 16, 16),   # the CATER widths: 64 -> 256 -> 3
    (64, 1, 3, 22, 14),    # 22 x 14 is ragged against the kernel's 16 x 8 tile
])
def test_plain_tail_equals_the_module_chain_in_f32(dim, input_dim, b, hh, ww):
    model = _model(dim, input_dim)
    gen = torch.Generator().manual_seed(1)
    h = torch.randn(b, hh, ww, dim // 4, generator=gen)
    x = torch.randn(b, hh // 2, ww // 2, dim, generator=gen)
    with torch.no_grad():
        got = vq_tail.vq_decode_tail(h, x, *_tail_args(model))
        want = _chain(model, h, x)
    assert got.shape == (b, hh, ww, input_dim) and got.dtype == torch.float32
    # the same f32 math, the bias and the 1x1 product summed in another order
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_on_the_cpu_is_the_layer_chain_bit_for_bit(dtype):
    model = _model(64).to(dtype)
    ids = torch.randint(0, 16, (3, 4, 4), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = model.decode(ids)
        z_q = codebook_lookup(model.codebook.embedding.weight, ids)
        want = model.decoder(z_q.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert torch.equal(got, want)


@pytest.fixture()
def on_card_spy(monkeypatch):
    """The route as on the card (``_on_card`` true for CPU tensors) with the
    op replaced by a spy that runs its plain version and counts the calls."""
    calls = []
    plain = vq_tail.vq_decode_tail

    def spy(*args):
        calls.append(args[0].shape)
        return plain(*args, impl="torch")

    monkeypatch.setattr(vqvae, "_on_card", lambda t: True)
    monkeypatch.setattr(vq_tail, "vq_decode_tail", spy)
    return calls


def test_bf16_decode_takes_the_fused_tail_and_is_no_less_precise(on_card_spy):
    model = _model(256)
    ids = torch.randint(0, 16, (4, 4, 4), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        exact = model.decode(ids)  # f32: the layer chain
        assert on_card_spy == []
        m16 = model.to(torch.bfloat16)
        fused = m16.decode(ids)
        assert on_card_spy == [(4, 32, 32, 64)]
        z_q = codebook_lookup(m16.codebook.embedding.weight, ids)
        chain = m16.decoder(z_q.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert fused.dtype == torch.bfloat16 and fused.shape == exact.shape
    # one rounding at the end against one at every layer of the chain's tail
    err_fused = float((fused.float() - exact).abs().max())
    err_chain = float((chain.float() - exact).abs().max())
    assert err_fused <= err_chain + 2 ** -8


def test_training_grad_mode_f32_and_f4_take_the_layer_chain(on_card_spy):
    ids = torch.randint(0, 16, (2, 4, 4), generator=torch.Generator().manual_seed(4))
    f8 = _model(256).to(torch.bfloat16)
    f8.decode(ids)  # autograd records
    f8.train()
    frames = torch.rand(2, 32, 32, 3).to(torch.bfloat16)
    x_tilde, _, _ = f8(frames)  # the training forward
    assert x_tilde.requires_grad
    with torch.no_grad():
        _model(256).decode(ids)  # f32
        _model(64).to(torch.bfloat16).decode(ids)  # widths the kernel does not take
        _model(64, down_ratio=4).to(torch.bfloat16).decode(ids)  # f4
    assert on_card_spy == []


def test_first_stage_decode_takes_the_tail_once_per_chunk(on_card_spy):
    first = FirstStageVQVAE(_model(256).to(torch.bfloat16))
    ids = torch.randint(0, 16, (2, 6, 2, 2), generator=torch.Generator().manual_seed(5))
    frames = first.decode(ids, max_chunk=5)  # 12 frames: chunks of 4, the largest divisor
    assert frames.shape == (2, 6, 16, 16, 3)
    assert on_card_spy == [(4, 16, 16, 64)] * 3


def test_the_route_is_off_on_the_cpu():
    model = _model(256).to(torch.bfloat16)
    z_q = torch.zeros(1, 2, 2, 1024, dtype=torch.bfloat16)
    with torch.no_grad():
        assert not model._fused_tail(z_q)


def test_vq_decode_tail_rejects_mismatched_shapes_and_impls():
    model = _model(64)
    args = _tail_args(model)
    h, x = torch.zeros(1, 8, 8, 16), torch.zeros(1, 4, 4, 64)
    with pytest.raises(ValueError):
        vq_tail.vq_decode_tail(h, torch.zeros(1, 4, 5, 64), *args)
    with pytest.raises(ValueError):
        vq_tail.vq_decode_tail(torch.zeros(1, 8, 8, 32), x, *args)
    with pytest.raises(ValueError):
        vq_tail.vq_decode_tail(h, x, *args, impl="pallas")
    assert vq_tail.kernel_takes(64, 256, 3)  # the f8 decoder at dim 256
    assert not vq_tail.kernel_takes(16, 64, 3) and not vq_tail.kernel_takes(64, 256, 1)


def _up(t):
    return F.interpolate(t, scale_factor=2, mode="nearest")


def _materialised_trunk(block, x):
    """``DecoderBlock.trunk`` with its upsample computed: the pointwise entry
    upsampled by ``F.interpolate``, then the second relu at full resolution."""
    if not block.upsample:
        return block.block[:6](x)
    return block.block[2:6](_up(block.block[:2](x)))


def _materialised(block, x):
    """``DecoderBlock.forward`` with its upsamples computed: the id path
    upsampled by ``F.interpolate`` and added to the materialised trunk's
    branch."""
    idp = x if block.id_path is None else block.id_path(x)
    y = block.block[6:](_materialised_trunk(block, x))
    return (_up(idp) if block.upsample else idp) + y


def _block_input(dim_in, dtype):
    """A channels-last (2, dim_in, 5, 7) input, as the decoder's NHWC views give."""
    x = torch.randn(2, 5, 7, dim_in, generator=torch.Generator().manual_seed(6))
    return x.to(dtype).permute(0, 3, 1, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# with and without id_path; at (4, 8) a bf16 trunk pixel is 4 bytes, too few for the
# upsample's 8-byte words, so it copies bf16 elements
@pytest.mark.parametrize("dim_in,dim_out", [(32, 16), (16, 16), (4, 8)])
def test_upsampling_decoder_block_is_the_materialised_chain_bit_for_bit(dtype, dim_in, dim_out):
    torch.manual_seed(7)
    block = vqvae.DecoderBlock(dim_in, dim_out, upsample=True).to(dtype)
    assert (block.id_path is None) == (dim_in == dim_out)
    x = _block_input(dim_in, dtype)
    with torch.no_grad():
        got, want = block(x), _materialised(block, x)
        trunk, trunk_want = block.trunk(x), _materialised_trunk(block, x)
    assert got.shape == (2, dim_out, 10, 14)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert want.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want) and torch.equal(trunk, trunk_want)


@pytest.mark.parametrize("dim_in,dim_out", [(32, 16), (16, 16)])
def test_upsampling_decoder_block_gradients_are_the_materialised_chains(dim_in, dim_out):
    """f32: the input's and the parameters' gradients sum the same four values
    of each 2x2 block, in another order."""
    torch.manual_seed(8)
    block = vqvae.DecoderBlock(dim_in, dim_out, upsample=True)
    seed = torch.randn(2, dim_out, 10, 14, generator=torch.Generator().manual_seed(9))
    grads = []
    for run in (block, lambda x: _materialised(block, x)):
        block.zero_grad()
        x = _block_input(dim_in, torch.float32).requires_grad_()
        (run(x) * seed).mean().backward()  # a mean, as a training loss is
        grads.append([x.grad] + [p.grad for p in block.parameters()])
    assert len(grads[1]) == len(list(block.parameters())) + 1
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func.overloadpacket)
        return func(*args, **(kwargs or {}))


def test_decode_on_the_card_route_runs_no_upsample_kernel(on_card_spy):
    first = FirstStageVQVAE(_model(256).to(torch.bfloat16))
    ids = torch.randint(0, 16, (2, 4, 2, 2), generator=torch.Generator().manual_seed(10))
    with torch.no_grad(), _OpLog() as log:
        first.decode(ids, max_chunk=4)  # 8 frames: 2 chunks of 4
    assert on_card_spy == [(4, 16, 16, 64)] * 2
    assert torch.ops.aten.convolution in log.ops  # the log sees the decoder's ops
    assert torch.ops.aten.upsample_nearest2d not in log.ops
