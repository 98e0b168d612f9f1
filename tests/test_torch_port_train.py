"""Stage-2 training in the port against the JAX package, on the CPU, in f32.

One tiny configuration (f8 VQ-VAE on 32-px frames, a 4x4 latent grid, dim
16, K 32, width 32, 3 decoder layers, 4 frames, the stochastic branch on,
dropout 0) for MAGE from frames through the VQ path, and its MAGE+ twin
(KL-AE first stage, continuous head, pre-LN cross-attention) fed
precomputed latents. JAX's weights are carried into the port by
``compat.from_jax``, and its gradients through the same exporter. The JAX
posterior noise comes from ``jax.random.normal``, patched while JAX traces
to return the numpy draw that the port gets as ``posterior_noise``; nothing
in ``mage_tpu`` changes.

Tolerances: loss terms within 1e-5 relative; each gradient tensor within
1e-4 of its largest |g|; one Adam step's parameters within 1e-3 * lr per
element; PID beta and state as JAX's, to f32 rounding.
"""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mage_tpu.training import mage_trainer as jtrainer  # noqa: E402
from mage_tpu.training import pid as jpid  # noqa: E402
from mage_tpu.training.lr import epoch_lr as jax_epoch_lr  # noqa: E402
from mage_tpu_torch import _build  # noqa: E402
from mage_tpu_torch.compat import from_jax  # noqa: E402
from mage_tpu_torch.models import layers as tl  # noqa: E402
from mage_tpu_torch.models.pipeline import MagePipeline  # noqa: E402
from mage_tpu_torch.training import autoresume, mage_trainer, pid  # noqa: E402
from mage_tpu_torch.training.checkpoint import Checkpointer  # noqa: E402
from mage_tpu_torch.training.lr import epoch_lr  # noqa: E402

B, FRAMES, RES, LAT, K, W, Z = 2, 4, 32, 4, 32, 32, 4
KL_RES = 8  # the MAGE+ first stage's frames (ch_mult 1, 2: 8 px -> the 4x4 grid)
LAYERS = dict(text_layers=1, ma_layers=1, dec_layers=3)
ALPHA, BETA, V_KL, LR = 0.001, 0.00025, 10.0, 1e-3
TERM_RTOL, GRAD_TOL, STEP_TOL = 1e-5, 1e-4, 1e-3


def _config(mage_plus: bool) -> dict:
    if mage_plus:
        dd = {"double_z": True, "z_channels": Z, "resolution": KL_RES, "in_channels": 3,
              "out_ch": 3, "ch": 32, "ch_mult": [1, 2], "num_res_blocks": 1,
              "attn_resolutions": [], "dropout": 0.0}
        first = {"target": "mage_tpu.models.autoencoder_kl.AutoencoderKL",
                 "params": {"embed_dim": Z, "ddconfig": dd}}
    else:
        first = {"target": "mage_tpu.models.vqvae.VectorQuantizedVAE",
                 "params": {"input_dim": 3, "down_ratio": 8, "dim": 16, "K": K}}
    return dict(
        first_stage_config=first,
        text_encoder_config={"target": "mage_tpu.models.layers.TransformerTextEncoder",
                             "params": {"vocab_size": 30, "context_length": 12,
                                        "transformer_width": W, "transformer_layers": 1,
                                        "output_dim": W, "padding_idx": 0, "dropout": 0.0}},
        ma_config={"target": "mage_tpu.models.layers.MAEncoder",
                   "params": {"layers": 1, "d_model": W}},
        generate_decoder_config={"target": "mage_tpu.models.mage.FlatAxialDecoder",
                                 "params": {"layers": 3, "model_channels": W,
                                            "in_channels": W,
                                            "out_channels": Z if mage_plus else K,
                                            "frames_length": FRAMES}},
        codebook_size=K, frames_length=FRAMES, image_resolution=LAT, vision_width=W,
        dropout=0.0, use_cids=not mage_plus, randomness=True, alpha=ALPHA, beta=BETA,
        v_kl=V_KL,
    )


def _batch(mage_plus: bool, seed: int = 0) -> dict:
    rng = np.random.RandomState(seed)
    text = np.zeros((B, 12), np.int32)
    text[:, 0] = 1
    text[:, 1:4] = rng.randint(3, 29, size=(B, 3))
    text[0, 4] = 2
    text[1, 3] = 2  # a shorter caption: more padding
    res = KL_RES if mage_plus else RES
    batch = {"images": rng.rand(B, FRAMES, res, res, 3).astype(np.float32) - 0.5,
             "text": text, "speed": rng.rand(B).astype(np.float32)}
    if mage_plus:
        batch["latents"] = rng.randn(B, FRAMES, LAT, LAT, Z).astype(np.float32)
    return batch


def _noise(seed: int = 1) -> np.ndarray:
    return np.random.RandomState(seed).randn(B, LAT, LAT, 64).astype(np.float32)


def _patched_normal(monkeypatch, noise: np.ndarray) -> None:
    """``jax.random.normal`` returns ``noise`` for the posterior's shape."""
    real = jax.random.normal

    def normal(key, shape=(), dtype=jnp.float32):
        if tuple(shape) == noise.shape:
            return jnp.asarray(noise, dtype)
        return real(key, shape, dtype)

    monkeypatch.setattr(jax.random, "normal", normal)


@pytest.fixture(scope="module")
def jax_pipelines():
    """JAX pipelines and params for MAGE and MAGE+ (the MAGE+ head's
    zero-init conv and its identity ``ln_q``/``ln_kv`` given random values,
    so every parameter has a gradient)."""
    import flax

    from mage_tpu.models.autoencoder_kl import FirstStageKL as JaxFirstStageKL
    from mage_tpu.models.pipeline import MagePipeline as JaxPipeline
    from mage_tpu.models.vqvae import VectorQuantizedVAE as JaxVQVAE

    out = {}
    for mage_plus in (False, True):
        cfg = _config(mage_plus)
        # the first stage's own init, jitted and at the test's frame size (the
        # pipeline's default runs eagerly on 128-px frames); MAGE+ is fed
        # latents, so its KL-AE's weights are never used: zeros of their shapes
        fs_params = cfg["first_stage_config"]["params"]
        if mage_plus:
            model = JaxFirstStageKL.from_config(fs_params, variables={}).model
            shapes = jax.eval_shape(model.init, {"params": jax.random.PRNGKey(0)},
                                    jnp.zeros((1, KL_RES, KL_RES, 3), jnp.float32),
                                    jax.random.PRNGKey(0))
            fs_vars = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes)
        else:
            fs_vars = jax.jit(JaxVQVAE(**fs_params).init)(
                {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, RES, RES, 3), jnp.float32))
        jp = JaxPipeline(**cfg, first_stage_variables=fs_vars)
        params = flax.core.unfreeze(jp.init(jax.random.PRNGKey(0), _batch(mage_plus)))
        if mage_plus:
            rng = np.random.RandomState(9)
            out_conv = params["generate_model"]["out_conv"]
            out_conv["kernel"] = jnp.asarray(rng.randn(*out_conv["kernel"].shape) * 0.3,
                                             jnp.float32)
            for ln in ("ln_q", "ln_kv"):
                p = params["ma_encoder"]["block_0"][ln]
                p["scale"] = jnp.asarray(1 + rng.randn(*p["scale"].shape) * 0.2, jnp.float32)
        out[mage_plus] = (jp, params)
    return out


def _port(jp, params, mage_plus: bool) -> MagePipeline:
    """The port's pipeline on JAX's weights (MAGE+ on the core's alone)."""
    tp = MagePipeline(**_config(mage_plus), device="cpu")
    if mage_plus:
        from_jax.load(tp.core, _export(params, tp))
    else:
        from_jax.load_pipeline(tp, params, jp.first_stage.variables, **LAYERS)
    return tp


def _export(tree, tp) -> dict:
    """A JAX params-shaped tree (params or gradients) -> the port's keys."""
    core = tp.core
    return from_jax.export_mage_core(tree, randomness=True, use_cids=core.use_cids,
                                     pre_ln=core.pre_ln, **LAYERS)


def _jax_loss(jp, batch, train=True):
    def loss(params):
        terms = jp.loss_terms(params, batch, jax.random.PRNGKey(3), train=train)
        final = terms["prediction"] + BETA * terms["kl_loss"] + ALPHA * terms["speed_l2"]
        return final, terms
    return loss


def _shift_invariant(mage_plus: bool) -> set:
    """Biases whose gradient is zero up to rounding at this width: each adds
    one vector per channel at every position of a tensor that a
    normalisation over those positions then takes in. The last
    motion-anchor block's ``c_proj`` feeds AdaIN's instance norm; for MAGE+
    the last decoder block's ``c_proj`` feeds the head's GroupNorm, whose 32
    groups hold one channel each at width 32."""
    keys = {f"ma_encoder.blocks.{LAYERS['ma_layers'] - 1}.mlp.c_proj.bias"}
    if mage_plus:
        keys.add(f"generate_model.blocks.{LAYERS['dec_layers'] - 1}.mlp.c_proj.bias")
    return keys


def _port_batch(batch, mage_plus):
    return {k: v for k, v in batch.items() if not (mage_plus and k == "images")}


# ---- (a) loss terms and (b) gradients --------------------------------------


@pytest.mark.parametrize("mage_plus", [False, True], ids=["mage_images", "mageplus_latents"])
def test_loss_terms_and_gradients_match_jax(mage_plus, jax_pipelines, monkeypatch):
    jp, params = jax_pipelines[mage_plus]
    batch = _batch(mage_plus)
    noise = _noise()
    _patched_normal(monkeypatch, noise)
    j_batch = {k: jnp.asarray(v) for k, v in _port_batch(batch, mage_plus).items()}
    j_grads, j_terms = jax.jit(jax.grad(_jax_loss(jp, j_batch), has_aux=True))(params)

    tp = _port(jp, params, mage_plus)
    terms = tp.loss_terms(_port_batch(batch, mage_plus), train=True,
                          posterior_noise=torch.from_numpy(noise))
    assert set(terms) == {"prediction", "kl_loss", "speed_l2"}
    for key, value in terms.items():
        np.testing.assert_allclose(value.item(), float(j_terms[key]), rtol=TERM_RTOL,
                                   err_msg=key)
    (terms["prediction"] + BETA * terms["kl_loss"] + ALPHA * terms["speed_l2"]).backward()

    want = {k: np.asarray(v) for k, v in _export(j_grads, tp).items()}
    got = {k: p.grad for k, p in tp.core.named_parameters()}
    unused = {k for k, g in got.items() if g is None}
    # MAGE (pre_ln=False) runs no ln_q/ln_kv; the exporter writes identities there
    assert unused == ({k for k in got if ".ln_q." in k or ".ln_kv." in k}
                      if not mage_plus else set())
    top = max(float(np.abs(w).max()) for w in want.values())
    shift_invariant = _shift_invariant(mage_plus)
    for key in shift_invariant:  # zero up to rounding in both packages
        for g in (got[key].numpy(), want[key]):
            assert np.abs(g).max() < 1e-6 * top, key
    for key, g in got.items():
        if g is None or key in shift_invariant:
            continue
        scale = float(np.abs(want[key]).max())
        np.testing.assert_allclose(g.numpy(), want[key], rtol=0, atol=GRAD_TOL * scale,
                                   err_msg=key)


@pytest.mark.parametrize("mage_plus", [False, True], ids=["mage_images", "mageplus_latents"])
def test_motion_and_early_weighted_loss_matches_jax(mage_plus, jax_pipelines, monkeypatch):
    """The opt-in loss weights (motion 0.5, early frames 1.0 on the first 2
    predicted frames), normalised to mean 1, for ids and for latents."""
    import copy

    jp, params = jax_pipelines[mage_plus]
    weights = dict(motion_loss_weight=0.5, early_loss_weight=1.0, early_loss_frames=2)
    jw = copy.copy(jp)
    jw.core = jp.core.clone(**weights)
    batch, noise = _batch(mage_plus, seed=13), _noise(14)
    _patched_normal(monkeypatch, noise)
    j_batch = {k: jnp.asarray(v) for k, v in _port_batch(batch, mage_plus).items()}
    j_terms = jax.jit(lambda p: jw.loss_terms(p, j_batch, jax.random.PRNGKey(3)))(params)
    tp = _port(jp, params, mage_plus)
    for name, value in weights.items():
        setattr(tp.core, name, value)
    with torch.no_grad():
        terms = tp.loss_terms(_port_batch(batch, mage_plus),
                              posterior_noise=torch.from_numpy(noise))
    np.testing.assert_allclose(terms["prediction"].item(), float(j_terms["prediction"]),
                               rtol=TERM_RTOL)
    tp.core.motion_loss_weight = tp.core.early_loss_weight = 0.0
    with torch.no_grad():
        uniform = tp.loss_terms(_port_batch(batch, mage_plus),
                                posterior_noise=torch.from_numpy(noise))
    assert abs(uniform["prediction"].item() - terms["prediction"].item()) > 1e-4


# ---- (c) one Adam step through each package's train step --------------------


@pytest.mark.parametrize("auto_beta", [False, True], ids=["fixed_beta", "auto_beta"])
def test_one_adam_step_matches_jax(auto_beta, jax_pipelines, monkeypatch):
    jp, params = jax_pipelines[False]
    batch = _batch(False, seed=5)
    noise = _noise(6)
    _patched_normal(monkeypatch, noise)
    monkeypatch.setattr(jp, "auto_beta", auto_beta)
    tx = jtrainer.make_mage_tx()
    own = jax.tree_util.tree_map(jnp.copy, params)  # the step donates its state
    state = jtrainer.MageTrainState(step=jnp.zeros((), jnp.int32), params=own,
                                    opt_state=tx.init(own))
    j_step = jtrainer.make_mage_train_step(jp, tx)
    j_beta = jpid.initial_pid_state() if auto_beta else BETA
    j_state, j_terms = j_step(state, jp.first_stage.variables,
                              {k: jnp.asarray(v) for k, v in batch.items()}, LR, j_beta,
                              ALPHA, jax.random.PRNGKey(3))

    tp = _port(jp, params, False)
    tp.auto_beta = auto_beta
    opt = mage_trainer.make_mage_optimizer(tp.core)
    step = mage_trainer.make_mage_train_step(tp, opt)
    terms = step(batch, LR, pid.initial_pid_state() if auto_beta else BETA, ALPHA,
                 posterior_noise=torch.from_numpy(noise))
    for key in ("prediction", "kl_loss", "speed_l2", "final_loss"):
        np.testing.assert_allclose(terms[key].item(), float(j_terms[key]), rtol=TERM_RTOL,
                                   err_msg=key)
    if auto_beta:
        assert 0.0 <= terms["beta"].item() <= 1.0
        np.testing.assert_allclose(terms["beta"].item(), float(j_terms["beta"]),
                                   rtol=TERM_RTOL, atol=1e-9)
        np.testing.assert_allclose(terms["_pid_state"].numpy(),
                                   np.asarray(j_terms["_pid_state"]), rtol=TERM_RTOL, atol=1e-9)
    # Adam's first update is lr * g / (|g| + eps): where |g| is near eps it
    # passes a gradient difference on amplified by eps / (|g| + eps)^2, so
    # each element is held to STEP_TOL * lr plus what the gradient
    # tolerance of the test above allows through that slope. The biases
    # whose gradients are rounding noise there are left out.
    want = _export(jax.device_get(j_state.params), tp)
    eps = opt.param_groups[0]["eps"]
    for key, p in tp.core.named_parameters():
        if key in _shift_invariant(False) or p.grad is None:
            continue
        g = p.grad.abs().numpy()
        slack = eps * GRAD_TOL * g.max() / (g + eps) ** 2
        err = np.abs(p.detach().numpy() - np.asarray(want[key]))
        bad = err > LR * (STEP_TOL + np.minimum(slack, 2.0))
        assert not bad.any(), (key, err[bad][:4], g[bad][:4])
        well = g > 100 * eps  # where Adam's slope is flat the bound is STEP_TOL * lr
        assert (err[well] <= STEP_TOL * LR).all(), key


# ---- (d) the PID controller and (e) the schedules ---------------------------


@pytest.mark.parametrize("anti_windup", [True, False])
def test_pid_matches_jax_over_a_kl_sweep(anti_windup):
    kls = np.concatenate([np.linspace(0.0, 250.0, 60), [0.5] * 200, [200.0] * 50,
                          np.linspace(300.0, -20.0, 40)]).astype(np.float32)
    j_state, t_state = jpid.initial_pid_state(), pid.initial_pid_state()
    j_host, t_host = jpid.PIDControl(anti_windup), pid.PIDControl(anti_windup)
    update = jax.jit(lambda s, kl: jpid.pid_update(s, 100.0, kl, anti_windup=anti_windup))
    for kl in kls:
        j_beta, j_state = update(j_state, kl)
        t_beta, t_state = pid.pid_update(t_state, 100.0, torch.tensor(kl),
                                         anti_windup=anti_windup)
        # f32 rounding of an integral summed over the sweep's 350 steps (XLA
        # may contract the multiply-add into one rounding)
        np.testing.assert_allclose(t_beta.item(), float(j_beta), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(t_state.numpy(), np.asarray(j_state), rtol=1e-6, atol=1e-7)
        assert t_host.pid(100.0, float(kl)) == j_host.pid(100.0, float(kl))
        assert abs(t_beta.item() - min(max(t_host.w_k1, 0.0), 1.0)) < 1e-6


def test_pid_closed_loop_holds_the_jax_equilibrium():
    """The closed loop of ``tests/test_mage_pipeline.py``: a first-order KL
    plant whose free steady state is above the setpoint; both twins must
    hold KL at the setpoint with beta near 0.75, as JAX's twins do."""
    kl_free, c, rate, target, steps = 10.0, 0.8, 0.05, 4.0, 12_000
    host = pid.PIDControl()
    kl = kl_free
    kls, betas = [], []
    for _ in range(steps):
        b, _ = host.pid(target, kl)
        kl += rate * (kl_free * (1.0 - c * b) - kl)
        kls.append(kl)
        betas.append(b)
    tail_kl, tail_beta = np.mean(kls[-1000:]), np.mean(betas[-1000:])
    assert abs(tail_kl - target) < 0.1 and 0.5 < tail_beta < 0.95
    assert np.std(betas[-1000:]) < 1e-3 and min(betas[-1000:]) > 0.0

    state, kl_t = pid.initial_pid_state(), torch.tensor(kl_free)
    kl_tr, beta_tr = [], []
    for _ in range(steps):
        beta, state = pid.pid_update(state, target, kl_t)
        kl_t = kl_t + rate * (kl_free * (1.0 - c * beta) - kl_t)
        kl_tr.append(kl_t.item())
        beta_tr.append(beta.item())
    assert abs(np.mean(kl_tr[-1000:]) - tail_kl) < 0.05
    assert abs(np.mean(beta_tr[-1000:]) - tail_beta) < 0.01


@pytest.mark.parametrize("cos", [True, False])
def test_epoch_lr_matches_jax(cos):
    for epoch in range(0, 60, 3):
        kw = dict(cos=cos, lr_steps=[30, 40], lr_gamma=0.1)
        assert epoch_lr(5e-5, epoch, 50, **kw) == jax_epoch_lr(5e-5, epoch, 50, **kw)


# ---- (f) remat, (g) routing ----------------------------------------------


def _loss_and_grads(tp, batch, noise, compute_dtype=None):
    """The train step's loss and gradients (its bf16 copies when
    ``compute_dtype`` is set) without the optimizer update."""
    tp.core.zero_grad(set_to_none=True)
    params = None
    if compute_dtype is not None:
        params = mage_trainer.cast_floating(dict(tp.core.named_parameters()), compute_dtype)
    terms = tp.loss_terms(batch, params=params, compute_dtype=compute_dtype,
                          posterior_noise=torch.from_numpy(noise))
    final = mage_trainer.train_loss(tp, terms, BETA, ALPHA)
    final.backward()
    return final.item(), {k: p.grad.clone() for k, p in tp.core.named_parameters()
                          if p.grad is not None}


@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16], ids=["f32", "bf16_copies"])
def test_remat_gives_the_same_loss_and_gradients(compute_dtype, jax_pipelines):
    """Recomputed blocks see the tensors the forward saw, the train step's
    bf16 parameter copies included."""
    jp, params = jax_pipelines[False]
    tp = _port(jp, params, False)
    batch, noise = _batch(False, seed=7), _noise(8)
    loss, grads = _loss_and_grads(tp, batch, noise, compute_dtype)
    tp.core.remat = tp.core.generate_model.remat = True
    loss_r, grads_r = _loss_and_grads(tp, batch, noise, compute_dtype)
    assert loss_r == loss
    assert grads_r.keys() == grads.keys()
    for key in grads:
        torch.testing.assert_close(grads_r[key], grads[key], rtol=0, atol=0, msg=key)


@pytest.mark.parametrize("spatial_attn", ["flat", "fusedblock"])
def test_train_mode_routes_spatial_blocks_around_the_kernel_ops(spatial_attn, monkeypatch):
    """Train mode runs no kernel op (their kernels carry no autograd graph
    of their own, and dropout acts there); eval mode runs one per spatial
    block call, as JAX gates its Pallas kernels on ``not train``."""
    calls = {"axial_slot_attention": 0, "axial_block_fused": 0}

    def counted(name):
        real = getattr(tl, name)

        def op(*args, **kwargs):
            calls[name] += 1
            return real(*args, **kwargs)
        return op

    for name in calls:
        monkeypatch.setattr(tl, name, counted(name))
    block = tl.AxialAttentionBlock(W, 1, axial_dim=2, spatial_attn=spatial_attn, dropout=0.1)
    x = torch.randn(2, 3, 4, 5, W)
    temporal = tl.AxialAttentionBlock(W, 1, axial_dim=1, spatial_attn=spatial_attn).eval()
    temporal(x, attn_bias=torch.zeros(3, 3))
    block.train()(x).sum().backward()
    assert calls == {"axial_slot_attention": 0, "axial_block_fused": 0}
    with torch.no_grad():
        block.eval()(x)
    op = "axial_block_fused" if spatial_attn == "fusedblock" else "axial_slot_attention"
    assert calls == {"axial_slot_attention": 0, "axial_block_fused": 0, op: 1}


def test_kernel_route_gradients_are_the_plain_versions():
    """``launch_differentiable`` with a forward that, like a kernel, carries
    no autograd graph gives the plain version's gradients."""
    from mage_tpu_torch.ops.axial_attention import _axial_plain

    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(6, 5, 16, generator=gen, requires_grad=True) for _ in range(3))
    up = torch.randn(6, 5, 16, generator=gen)

    def graphless(*qkv):
        with torch.no_grad():
            return _axial_plain(*qkv, 2)

    out = _build.launch_differentiable(graphless, lambda *qkv: _axial_plain(*qkv, 2), q, k, v)
    got = torch.autograd.grad((out * up).sum(), (q, k, v))
    want = torch.autograd.grad((_axial_plain(q, k, v, 2) * up).sum(), (q, k, v))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_spectral_norm_basic_block_raises():
    """JAX's ``spectral`` option builds spectral-norm convs (held to flax in
    ``test_torch_port_utils.py``), whose power-iteration state is part of the
    state dict: a plain block's state dict, which lacks it, raises on a
    strict load."""
    with torch.random.fork_rng():  # the blocks' init leaves the global draws as they were
        block = tl.BasicBlock3D(32, 32, spectral=True)
        assert isinstance(block.conv1, tl.SpectralConv3d)
        assert isinstance(block.conv2, tl.SpectralConv3d)
        assert not isinstance(tl.BasicBlock3D(32, 32).conv1, tl.SpectralConv3d)
        assert {"conv1.u", "conv1.sigma", "conv2.u", "conv2.sigma"} <= set(block.state_dict())
        with pytest.raises(RuntimeError, match="conv1.u"):
            block.load_state_dict(tl.BasicBlock3D(32, 32).state_dict())


# ---- (h) the trainer, checkpoints and resume --------------------------------


@pytest.mark.parametrize("auto_beta", [False, True], ids=["fixed_beta", "auto_beta"])
def test_trainer_trains_checkpoints_and_resumes(auto_beta, tmp_path):
    cfg = {**_config(False), "dropout": 0.1, "auto_beta": auto_beta}
    tp = MagePipeline(**cfg, device="cpu", seed=3)
    train_cfg = {"epoch": 1, "lr": 1e-3, "cos": True, "checkpoint_every": 8}
    trainer = mage_trainer.MageTrainer(tp, train_cfg, str(tmp_path / "ckpt"))
    trainer.init_state()
    batch = _batch(False, seed=11)
    losses = []
    for i in range(8):
        beta = trainer.pid_state if auto_beta else trainer.beta
        terms = trainer.train_step(batch, 1e-3, beta, ALPHA,
                                   generator=torch.Generator().manual_seed(i))
        if auto_beta:
            trainer.pid_state = terms.pop("_pid_state")
            trainer.beta = terms["beta"].item()
            assert 0.0 <= trainer.beta <= 1.0
        trainer.iteration += 1
        losses.append(terms["final_loss"].item())
    assert losses[-1] < losses[0], losses

    val = trainer.validate_and_checkpoint([batch, _batch(False, seed=12)], epoch=0)
    assert np.isfinite(val)
    assert trainer.ckpt.exists("model_best") and trainer.ckpt.exists("iteration_8")
    assert trainer.ckpt.latest("iteration_") == "iteration_8"
    host = json.loads((tmp_path / "ckpt" / "trainer_state.json").read_text())
    assert host["iteration"] == 8 and host["best_loss"] == val
    assert ("pid" in host) == auto_beta
    saved = {k: v.clone() for k, v in tp.core.state_dict().items()}
    pid_before = None if trainer.pid_state is None else trainer.pid_state.clone()

    # a fresh trainer on other weights resumes the step, weights, best loss and PID
    fresh = mage_trainer.MageTrainer(MagePipeline(**cfg, device="cpu", seed=4), train_cfg,
                                     str(tmp_path / "ckpt"))
    fresh.init_state()
    fresh.resume("model_best")
    assert fresh.iteration == 8 and fresh.best_loss == val
    for key, value in fresh.pipeline.core.state_dict().items():
        torch.testing.assert_close(value, saved[key], rtol=0, atol=0)
    assert fresh.optimizer.state_dict()["state"].keys() == trainer.optimizer.state_dict()[
        "state"].keys()
    if auto_beta:
        torch.testing.assert_close(fresh.pid_state, pid_before, rtol=0, atol=0)
        assert fresh.beta == trainer.beta
    # fit runs the loop through the same step
    fresh.fit([batch], [batch])
    assert fresh.iteration == 9


def test_autoresume_round_trip_and_corrupt_file(tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    assert autoresume.try_restore_last(ckpt) is None
    state = {"model": {"w": torch.arange(3.0)}, "pid": torch.tensor([1.0, 2.0, 3.0])}
    autoresume.save_last(ckpt, 4, 0.5, state)
    epoch, best, restored = autoresume.try_restore_last(ckpt)
    assert (epoch, best) == (5, 0.5)
    torch.testing.assert_close(restored["pid"], state["pid"])
    whole = open(ckpt.path(autoresume.TAG), "rb").read()
    for cut in (len(whole) // 2, 0):  # a write cut by a crash
        with open(ckpt.path(autoresume.TAG), "wb") as fp:
            fp.write(whole[:cut])
        assert autoresume.try_restore_last(ckpt) is None
