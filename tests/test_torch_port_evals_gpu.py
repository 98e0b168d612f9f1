"""The evaluation path's I3D on the card against the CPU, in f64 and in f32
with TF32 off. It has no kernel of its own (cuDNN runs its convs, as XLA runs JAX's),
so these hold the card's run of the port's modules: one
``train_fvd_extractor`` step of ``LabelI3D`` (logits, loss, gradients, the
parameters after the AdamW step and the BatchNorm statistics it moved) and
the trained trunk's Mixed_4f features through ``load_trained_extractor``,
at the CATER extractor's shape (128 px, 10 frames; batch 8 for the step).

Each test needs a CUDA device and skips without one (the decision is taken
inside a fixture). On the card's machine, which has no JAX, run them with
``python3 -m pytest --noconftest -q tests/test_torch_port_evals_gpu.py``.
"""

import copy
import os

import numpy as np
import pytest
import torch

from mage_tpu_torch.cli import train_fvd_extractor
from mage_tpu_torch.evals import i3d


@pytest.fixture()
def no_tf32():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _clips(seed=0, n=2, t=10, size=128):
    gen = torch.Generator().manual_seed(seed)
    return torch.rand(n, t, size, size, 3, generator=gen) * 2 - 1


def _train_step(model, dev, dtype, lr=3e-4, n=8):
    """One ``train_fvd_extractor`` step of ``model`` on ``dev`` in ``dtype``
    at the extractor's batch -> (train-mode logits before it, loss,
    gradients, floating state after), f64 on the CPU."""
    clips = _clips(n=n).to(dev, dtype)
    labels = (torch.arange(4 * n).reshape(n, 4) % 3 == 0).to(dev, dtype)
    with torch.no_grad():
        logits = copy.deepcopy(model).train()(clips)
    step = train_fvd_extractor.make_train_step(
        model, train_fvd_extractor.make_optimizer(model, lr))
    loss = step(clips, labels, lr)
    return (logits.double().cpu(), float(loss),
            {k: p.grad.double().cpu() for k, p in model.named_parameters()},
            {k: v.double().cpu() for k, v in model.state_dict().items()
             if v.is_floating_point()})


def _rel(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def test_label_i3d_train_step_on_the_card_matches_the_cpu(no_tf32):
    """One step at the extractor's batch (8), on the card and on the CPU.
    In f64 every tensor is held: the logits, the loss, each gradient and
    each running statistic within 1e-9 of its tensor's largest |value| of
    the CPU's, and each parameter after the AdamW step within that plus
    what its gradient's difference can move it: the first step moves p by
    lr g / (|g| + eps), at most lr / eps per unit of g, which a gradient
    near 0 (a dead channel's, rounding noise in f64) reaches. In f32 (TF32
    off) the forward is held: logits and loss within 1e-4 of the CPU's, and
    each running statistic within 1e-5 of its tensor's largest |value|.
    The f32 gradients are held through the f64 step only: at a random init
    the step is ill-conditioned, so f32 on either device leaves most
    tensors' gradients percents of their largest |g| from f64 (the test
    prints how far), and Adam's first step follows their signs."""
    lr, eps = 3e-4, 1e-8  # the step's learning rate, AdamW's eps
    model = i3d.LabelI3D(4)
    i3d.init_label_i3d(model, torch.Generator().manual_seed(0))
    ref = _train_step(copy.deepcopy(model).double(), "cpu", torch.float64, lr)
    card = _train_step(copy.deepcopy(model).cuda().double(), "cuda", torch.float64, lr)
    torch.testing.assert_close(card[0], ref[0], rtol=0, atol=1e-9 * float(ref[0].abs().max()))
    assert card[1] == pytest.approx(ref[1], rel=1e-9)
    for key, want in ref[2].items():
        assert _rel(card[2][key], want) <= 1e-9, key
    for key, want in ref[3].items():
        slack = 1e-9 * float(want.abs().max())
        if key in ref[2]:
            slack = slack + lr / eps * (card[2][key] - ref[2][key]).abs()
        assert bool(((card[3][key] - want).abs() <= slack).all()), key
    print("f64 card against CPU, of each tensor's largest |value| (gradients, state):",
          max(_rel(card[2][k], g) for k, g in ref[2].items()),
          max(_rel(card[3][k], v) for k, v in ref[3].items()))

    card = _train_step(copy.deepcopy(model).cuda(), "cuda", torch.float32)
    cpu = _train_step(model, "cpu", torch.float32)
    torch.testing.assert_close(card[0], cpu[0], rtol=0, atol=1e-4)
    assert card[1] == pytest.approx(cpu[1], abs=1e-4)
    for key, want in cpu[3].items():
        if "running" in key:
            assert _rel(card[3][key], want) <= 1e-5, key
    spread = {name: [_rel(run[2][k], g) for k, g in ref[2].items()]
              for name, run in (("card", card), ("cpu", cpu))}
    print("f32 gradients from f64 (largest, tensors past 1e-3, tensors):",
          {name: (max(v), sum(x > 1e-3 for x in v), len(v)) for name, v in spread.items()})


def test_trained_extractor_features_on_the_card_match_the_cpu(no_tf32, tmp_path):
    """A trunk saved as ``train_fvd_extractor`` saves it, through
    ``load_trained_extractor`` on each device: Mixed_4f features within 1e-4
    of the largest |feature|."""
    from mage_tpu_torch.training.checkpoint import Checkpointer

    model = i3d.LabelI3D(4)
    i3d.init_label_i3d(model, torch.Generator().manual_seed(1))
    with torch.no_grad():
        model.train()(_clips(2))  # running statistics away from 0 and 1
    Checkpointer(os.path.join(tmp_path, "i3d")).save("best", model.i3d.state_dict())
    videos = _clips(3, n=3).numpy()
    feats = {}
    for dev in ("cpu", "cuda"):
        extract, prov, dim = i3d.load_trained_extractor(str(tmp_path), batch_size=2, device=dev)
        feats[dev] = extract(videos)
        assert feats[dev].shape == (3, dim) == (3, 832) and prov == i3d.PROVENANCE
    np.testing.assert_allclose(feats["cuda"], feats["cpu"], rtol=0,
                               atol=1e-4 * np.abs(feats["cpu"]).max())
