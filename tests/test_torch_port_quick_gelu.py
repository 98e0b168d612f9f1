"""QuickGELU (``ops.quick_gelu``): the CPU path, the backward's formula, the
dispatch and the launchers' checks; on the card, the kernels.

On the CPU: the op is the plain chain bit for bit, with autograd through it;
the backward kernel's formula, run plain in f64, is autograd's gradient of
the chain; ``_QuickGelu`` saves x only and its backward runs the formula
(with the kernels' launchers stood in by their plain versions); a CPU
tensor launches nothing; the launchers reject what the kernels do not take;
``MLP`` runs the op on its tensor-parallel branch as on its plain one.

On the card (skipped without one; ``python3 -m pytest --noconftest -q
tests/test_torch_port_quick_gelu.py``): the forward bit-equal to the
three-kernel chain for every bf16 value, for 2^20 seeded f32 values with
the special ones, at the AR core's MLP hidden and at ragged sizes; the
backward bit-equal to its formula, and no further from autograd's f32
gradient of the chain than autograd's bf16 one is; one launch a forward
and one a backward.
"""

import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from mage_tpu_torch import _build
from mage_tpu_torch.models import layers
from mage_tpu_torch.ops import quick_gelu as qg
from mage_tpu_torch.parallel import dryrun
from mage_tpu_torch.parallel import tensor_parallel as tp
from mage_tpu_torch.utils import trace

INT = {torch.bfloat16: torch.int16, torch.float32: torch.int32, torch.float64: torch.int64}


def _launched():
    """The forward and backward launches counted so far in the process."""
    counts = trace.launch_counts()
    return counts.get("quick_gelu", 0), counts.get("quick_gelu_bwd", 0)


def _chain(x):
    """The activation as the port wrote it before the kernel."""
    return x * torch.sigmoid(1.702 * x)


def _specials(dtype, device="cpu"):
    fi = torch.finfo(dtype)
    vals = [0.0, -0.0, float("inf"), float("-inf"), float("nan"), fi.max, -fi.max, fi.tiny,
            -fi.tiny, fi.smallest_normal / 8, -fi.smallest_normal / 8, 1.0, -0.75, 60.0, -60.0]
    return torch.tensor(vals, dtype=dtype, device=device)


def _bits_equal(got, want):
    """Bit for bit where ``want`` is a number, NaN where it is NaN."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    g, w = got.view(INT[got.dtype])[~nan], want.view(INT[want.dtype])[~nan]
    assert torch.equal(g, w), f"{int((g != w).sum())} of {w.numel()} values differ"


# ---- on the CPU ---------------------------------------------------------------


@pytest.mark.parametrize("layout", ["flat", "rows"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_the_cpu_path_is_the_plain_chain_bit_for_bit(dtype, layout):
    """A flat vector and (rows, 4 d) as the MLP gives it; with autograd
    recording and under ``no_grad``."""
    gen = torch.Generator().manual_seed(0)
    x = torch.cat([torch.randn(4096, generator=gen, dtype=torch.float64) * 6,
                   _specials(torch.float64)]).to(dtype)
    if layout == "rows":
        x = x[:4096].reshape(64, 64)
    _bits_equal(qg.quick_gelu(x), _chain(x))
    with torch.no_grad():
        _bits_equal(qg.quick_gelu(x.clone().requires_grad_()), _chain(x))
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    g = torch.randn(x.shape, generator=gen).to(dtype)
    qg.quick_gelu(xa).backward(g)
    _chain(xb).backward(g)
    _bits_equal(xa.grad, xb.grad)
    assert layers.quick_gelu is qg.quick_gelu


def test_the_backward_formula_is_autograds_gradient_of_the_chain_in_f64():
    gen = torch.Generator().manual_seed(1)
    x = torch.cat([torch.linspace(-80, 80, 20001, dtype=torch.float64),
                   torch.randn(20000, generator=gen, dtype=torch.float64) * 4,
                   torch.tensor([1e300, -1e300, 0.0, -0.0], dtype=torch.float64)])
    g = torch.randn(x.shape, generator=gen, dtype=torch.float64)
    xr = x.clone().requires_grad_()
    (want,) = torch.autograd.grad(_chain(xr), xr, g)
    got = qg.quick_gelu_grad_plain(x, g)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-15)
    for dtype in (torch.float32, torch.bfloat16):  # one rounding of the f32 value
        got = qg.quick_gelu_grad_plain(x.to(dtype), g.to(dtype))
        assert got.dtype == dtype
        _bits_equal(got, qg.quick_gelu_grad_plain(x.to(dtype).float(),
                                                  g.to(dtype).float()).to(dtype))


def _stand_in_kernels(monkeypatch):
    """Route CPU tensors to the kernel path, with the launchers' plain
    versions in place of the launches; returns the calls by launcher."""
    calls = {"forward": 0, "backward": 0}

    def forward(x):
        calls["forward"] += 1
        assert not torch.is_grad_enabled() or not x.requires_grad
        return qg.quick_gelu_plain(x.detach())

    def backward(x, g):
        calls["backward"] += 1
        return qg.quick_gelu_grad_plain(x, g)

    monkeypatch.setattr(qg, "_on_card", lambda x: True)
    monkeypatch.setattr(qg, "_forward_cuda", forward)
    monkeypatch.setattr(qg, "_backward_cuda", backward)
    return calls


def test_the_function_saves_x_only_and_runs_the_backward_formula(monkeypatch):
    calls = _stand_in_kernels(monkeypatch)
    gen = torch.Generator().manual_seed(2)
    x = (torch.randn(64, 48, generator=gen, dtype=torch.float64) * 5).requires_grad_()
    g = torch.randn(64, 48, generator=gen, dtype=torch.float64)
    y = qg.quick_gelu(x)
    assert calls == {"forward": 1, "backward": 0}
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 1 and torch.equal(saved[0], x)
    y.backward(g)
    assert calls == {"forward": 1, "backward": 1}
    xr = x.detach().clone().requires_grad_()
    (want,) = torch.autograd.grad(_chain(xr), xr, g)
    torch.testing.assert_close(x.grad, want, rtol=1e-12, atol=1e-15)
    with torch.no_grad():  # no gradient wanted: the forward alone
        qg.quick_gelu(x)
    qg.quick_gelu(x.detach())
    assert calls == {"forward": 3, "backward": 1}


def test_off_the_card_no_kernel_launches():
    before = _launched()
    trace.clear()
    with trace.span("probe"):
        x = torch.randn(8, 16, requires_grad=True)
        qg.quick_gelu(x).sum().backward()
        qg.quick_gelu(x.detach().half())  # any dtype on the CPU
    assert _launched() == before
    assert trace.records()[-1]["launches"] == {}
    trace.clear()


@pytest.mark.parametrize("case,error", [
    ("float16", TypeError), ("float64", TypeError), ("transposed", ValueError),
    ("misaligned", ValueError), ("on_the_cpu", ValueError), ("shapes", ValueError)])
def test_the_launchers_reject_what_the_kernels_do_not_take(case, error):
    make = {"float16": torch.Tensor.half, "float64": torch.Tensor.double,
            "transposed": torch.Tensor.t, "misaligned": lambda t: t.view(-1)[1:]}.get(
                case, lambda t: t)
    x, g = make(torch.randn(64, 32)), make(torch.randn(64, 32))
    if case == "shapes":
        g = g[:32]
    before = _launched()
    if case != "shapes":
        with pytest.raises(error):
            qg._forward_cuda(x)
    with pytest.raises(error):
        qg._backward_cuda(x, g)
    assert _launched() == before


def _mlp(d, gen, dtype=torch.float64):
    mlp = layers.MLP(d).to(dtype)
    with torch.no_grad():
        for p in mlp.parameters():
            p.copy_(torch.randn(p.shape, generator=gen, dtype=dtype) * 0.3)
    return mlp


def test_the_mlp_runs_the_op_on_its_plain_branch(monkeypatch):
    gen = torch.Generator().manual_seed(3)
    mlp = _mlp(8, gen)
    x = torch.randn(5, 7, 8, generator=gen, dtype=torch.float64)
    want = mlp.c_proj(_chain(mlp.c_fc(x)))
    _bits_equal(mlp(x), want)
    calls = _stand_in_kernels(monkeypatch)
    x.requires_grad_()
    mlp(x).sum().backward()
    assert calls == {"forward": 1, "backward": 1}


def test_the_mlp_runs_the_op_on_its_tensor_parallel_branch(monkeypatch):
    """One gloo rank holding the first half of the hidden units, as rank 0
    of a two-way split does: the branch is ``row_linear(quick_gelu(
    column_linear(x)))`` on this rank's rows and columns, bit for bit."""
    gen = torch.Generator().manual_seed(4)
    d = 8
    full = _mlp(d, gen)
    mlp = layers.MLP(d).to(torch.float64)
    with torch.no_grad():
        mlp.c_fc.weight = torch.nn.Parameter(full.c_fc.weight[:2 * d].clone())
        mlp.c_proj.weight = torch.nn.Parameter(full.c_proj.weight[:, :2 * d].clone())
        mlp.c_fc.bias.copy_(full.c_fc.bias)
        mlp.c_proj.bias.copy_(full.c_proj.bias)
    x = torch.randn(6, d, generator=gen, dtype=torch.float64)
    h = _chain(F.linear(x, mlp.c_fc.weight, mlp.c_fc.bias[:2 * d]))
    want = F.linear(h, mlp.c_proj.weight) + mlp.c_proj.bias
    port = dryrun.free_port()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    try:
        with tp.model_axis(dist.group.WORLD):
            _bits_equal(mlp(x), want)
            calls = _stand_in_kernels(monkeypatch)
            mlp(x.clone().requires_grad_()).sum().backward()
            assert calls == {"forward": 1, "backward": 1}
    finally:
        dist.destroy_process_group()


# ---- on the card --------------------------------------------------------------


@pytest.fixture()
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def test_the_forward_is_the_chain_for_every_bf16_value(gen):
    x = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32, device="cuda").to(
        torch.int16).view(torch.bfloat16)
    _bits_equal(qg.quick_gelu(x), _chain(x))


def test_the_forward_is_the_chain_in_f32(gen):
    x = torch.cat([torch.randn(2 ** 20, generator=gen, device="cuda") * 8,
                   torch.rand(2 ** 16, generator=gen, device="cuda") * 200 - 100,
                   _specials(torch.float32, "cuda")])
    _bits_equal(qg.quick_gelu(x), _chain(x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8192, 2048), (1001, 7), (3,), (2, 5, 9), (4, 1024)])
def test_kernels_at_the_mlp_hidden_and_ragged_sizes(gen, dtype, shape):
    """(8192, 2048) is the AR core's hidden; 7007, 3 and 90 elements are no
    whole number of 16-byte vectors; 4096 fills one block exactly."""
    x = (torch.randn(shape, generator=gen, device="cuda") * 4).to(dtype)
    g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    _bits_equal(qg.quick_gelu(x), _chain(x))
    _bits_equal(qg._backward_cuda(x, g), qg.quick_gelu_grad_plain(x, g))
    with pytest.raises(ValueError):  # 16-byte alignment
        qg.quick_gelu(torch.empty(x.numel() + 1, dtype=dtype, device="cuda")[1:])


def _rel_errors(got, ref):
    """Max and median |got - ref| / |ref| over the elements whose reference
    is a normal f32 number; a NaN or infinite ``got`` there counts as an
    infinite error (autograd's bf16 chain overflows ``g * x`` near bf16's
    largest values)."""
    ref = ref.double()
    ok = torch.isfinite(ref) & (ref.abs() >= torch.finfo(torch.float32).smallest_normal)
    err = ((got.double() - ref).abs() / ref.abs())[ok]
    err = torch.nan_to_num(err, nan=float("inf"))
    return float(err.max()), float(err.median())


@pytest.mark.parametrize("grad", ["ones", "seeded"])
def test_the_backward_is_no_worse_than_autograds_bf16_chain(gen, grad):
    bits = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32, device="cuda").to(torch.int16)
    x = bits.view(torch.bfloat16)
    x = x[torch.isfinite(x)]
    g = (torch.ones_like(x) if grad == "ones"
         else torch.randn(x.shape, generator=gen, device="cuda").to(torch.bfloat16))

    def grad_of(fn, xv, gv):
        xv = xv.clone().requires_grad_()
        (out,) = torch.autograd.grad(fn(xv), xv, gv)
        return out

    ref = grad_of(_chain, x.float(), g.float())
    kernel = grad_of(qg.quick_gelu, x, g)
    chain = grad_of(_chain, x, g)
    assert kernel.dtype == torch.bfloat16
    k_max, k_med = _rel_errors(kernel, ref)
    c_max, c_med = _rel_errors(chain, ref)
    print(f"relative error against f32 autograd: kernel max {k_max} median {k_med}; "
          f"bf16 chain max {c_max} median {c_med}")
    assert k_max <= c_max and k_med <= c_med and k_max < 2 ** -7


def test_the_f32_backward_is_near_f64(gen):
    specials = _specials(torch.float32, "cuda")
    x = torch.cat([torch.randn(2 ** 20, generator=gen, device="cuda") * 8,
                   specials[torch.isfinite(specials)]])
    g = torch.randn(x.shape, generator=gen, device="cuda")
    xr = x.clone().requires_grad_()
    qg.quick_gelu(xr).backward(g)
    x64 = x.double().requires_grad_()
    (want,) = torch.autograd.grad(_chain(x64), x64, g.double())
    err = (xr.grad.double() - want).abs()
    assert bool((err <= 1e-5 * want.abs() + 1e-6 * g.double().abs()).all())


def test_one_launch_a_forward_and_one_a_backward(gen):
    """By the launch totals; the caller's span counts the forward (the
    backward runs on autograd's device thread, outside it)."""
    mlp = layers.MLP(512).to(device="cuda", dtype=torch.bfloat16)
    x = torch.randn(3, 64, 512, generator=gen, device="cuda").to(torch.bfloat16)
    for need_grad in (False, True):
        before = _launched()
        trace.clear()
        with trace.span("probe"):
            xi = x.clone().requires_grad_(need_grad)
            out = mlp(xi) if need_grad else mlp.requires_grad_(False)(xi)
            if need_grad:
                out.sum().backward()
        mlp.requires_grad_(True)
        assert trace.records()[-1]["launches"].get("quick_gelu") == 1
        after = _launched()
        assert (after[0] - before[0], after[1] - before[1]) == (1, int(need_grad))
        torch.cuda.synchronize()
    trace.clear()
    with torch.no_grad():
        _bits_equal(mlp(x), mlp.c_proj(_chain(mlp.c_fc(x))))


def test_graph_capture_counts_the_launch_once_a_replay(gen):
    x = torch.randn(1024, 2048, generator=gen, device="cuda").to(torch.bfloat16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        qg.quick_gelu(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = _launched()[0]
    with _build.capturing_launches() as captured, torch.cuda.graph(graph):
        y = qg.quick_gelu(x)
    assert _launched()[0] == before and captured == {"quick_gelu": 1}
    for _ in range(2):
        graph.replay()
        _build.credit(captured)
    torch.cuda.synchronize()
    assert _launched()[0] == before + 2
    _bits_equal(y, _chain(x))

