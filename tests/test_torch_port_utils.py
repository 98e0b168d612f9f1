"""The port's utilities against the JAX package, on the CPU, in f32: the
profiling module (FLOP helpers, ``cost_analysis``, ``profile_trace``,
``enable_debug_checks``) and the spectral-norm ``BasicBlock3D``.

The spectral block is held against flax's on weights carried by
``compat.from_jax``: train- and eval-mode outputs within 1e-5 of the largest
|output|, and the stored ``u`` and ``sigma`` after a train call within 1e-5.
"""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mage_tpu.models.layers import BasicBlock3D as JaxBlock  # noqa: E402
from mage_tpu.utils import profiling as jax_profiling  # noqa: E402
from mage_tpu_torch.compat import from_jax  # noqa: E402
from mage_tpu_torch.models.layers import BasicBlock3D, SpectralConv3d  # noqa: E402
from mage_tpu_torch.utils import profiling  # noqa: E402

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def keep_global_torch_rng():
    """Leave torch's global generator as this module found it: tests in
    other files draw from it unseeded, so their draws must not depend on
    whether this module ran first in their worker."""
    with torch.random.fork_rng():
        yield


@pytest.mark.parametrize("args", [(512, 2560, 10), (64, 16, 16), (512, 4096, 16)])
def test_block_flop_helpers_equal_jax(args):
    assert profiling.axial_block_flops(*args) == jax_profiling.axial_block_flops(*args)
    d = args[0]
    assert profiling.cross_attn_flops(d) == jax_profiling.cross_attn_flops(d)
    assert profiling.cross_attn_flops(d, 64, 7) == jax_profiling.cross_attn_flops(d, 64, 7)


@pytest.mark.parametrize("kwargs", [{}, dict(d_model=64, layers=3, frames_length=4,
                                            resolution=8), dict(frames_length=16)])
def test_decoder_flops_equal_jax(kwargs):
    assert profiling.mage_decoder_flops(**kwargs) == jax_profiling.mage_decoder_flops(**kwargs)


def test_cost_analysis_counts_a_linear_as_two_m_n_k():
    m, k, n = 8, 16, 12
    lin = torch.nn.Linear(k, n)
    x = torch.randn(m, k)
    assert profiling.cost_analysis(lin, x) == {"flops": 2 * m * n * k}
    assert profiling.cost_analysis(torch.matmul, x, torch.randn(k, n)) == {"flops": 2 * m * n * k}


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profiling.profile_trace(str(tmp_path / "trace")) as prof:
        torch.randn(32, 32) @ torch.randn(32, 32)
    events = json.loads((tmp_path / "trace" / profiling.TRACE_FILE).read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert any("mm" in e.key for e in prof.key_averages())


def test_enable_debug_checks_turns_anomaly_detection_on_and_off():
    try:
        profiling.enable_debug_checks()
        assert torch.is_anomaly_enabled()
    finally:
        profiling.enable_debug_checks(False)
    assert not torch.is_anomaly_enabled()


def _blocks(downsample, stride):
    jb = JaxBlock(out_planes=32, spectral=True, downsample=downsample, stride=stride,
                  stride_t=stride)
    x = np.random.RandomState(0).randn(2, 4, 8, 8, 16 if downsample else 32).astype(np.float32)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(jb.init)(jax.random.PRNGKey(0),
                                                                    jnp.asarray(x)))
    tb = BasicBlock3D(x.shape[-1], 32, stride=stride, stride_t=stride, downsample=downsample,
                      spectral=True)
    from_jax.load(tb, from_jax.export_basic_block3d(variables))
    return jb, variables, tb, x


def _port(tb, x):
    return tb(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1).detach().numpy()


@pytest.mark.parametrize("downsample, stride", [(True, 2), (False, 1)])
def test_spectral_block_matches_flax_in_train_and_eval(downsample, stride):
    jb, variables, tb, x = _blocks(downsample, stride)
    assert isinstance(tb.conv1, SpectralConv3d) and isinstance(tb.conv2, SpectralConv3d)
    stats = variables["batch_stats"]
    # three train calls: the power iteration persists in u and sigma
    for _ in range(3):
        want, mut = jb.apply({"params": variables["params"], "batch_stats": stats},
                             jnp.asarray(x), train=True, mutable=["batch_stats"])
        stats = jax.tree_util.tree_map(np.asarray, mut["batch_stats"])
        got = _port(tb.train(), x)
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=TOL * np.abs(want).max())
        carried = from_jax.export_basic_block3d({"params": variables["params"],
                                                 "batch_stats": stats})
        for key in ("conv1.u", "conv1.sigma", "conv2.u", "conv2.sigma"):
            np.testing.assert_allclose(tb.state_dict()[key].numpy(), carried[key],
                                       rtol=TOL, atol=TOL, err_msg=key)
    # eval iterates from the stored u but stores nothing, in both packages
    u_before = tb.conv1.u.clone()
    want = jb.apply({"params": variables["params"], "batch_stats": stats}, jnp.asarray(x),
                    train=False)
    got = _port(tb.eval(), x)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=TOL * np.abs(want).max())
    torch.testing.assert_close(tb.conv1.u, u_before, rtol=0, atol=0)


def test_spectral_sigma_carries_the_gradient():
    conv = SpectralConv3d(4, 6, 3, padding=1, bias=False)
    x = torch.randn(1, 4, 3, 3, 3)
    conv(x).square().sum().backward()
    # a plain conv on the same normalised weight, with sigma held fixed, has
    # another gradient: the division by sigma is differentiated through
    w = conv.weight.detach().clone().requires_grad_(True)
    torch.nn.functional.conv3d(x, w / conv.sigma, padding=1).square().sum().backward()
    assert not torch.allclose(conv.weight.grad, w.grad)
    assert conv.u.requires_grad is False and conv.sigma.requires_grad is False
