"""Stage-1 training in the port against the JAX package, on the CPU, in f32.

The VQ-VAE straight-through quantizer, the f4 (with BatchNorm) and f8
VQ-VAE's training forward, train, eval, reconstruction and restart steps,
and the KL autoencoder's training forward and loss, at tiny sizes (dim 16,
K 32, 32-px frames; a 16-px KL-AE with ch 32). JAX's weights and gradients
are carried into the port by ``compat.from_jax``. Then the MNIST config's
pipeline (f4 first stage) through ``generate_cached``, and the stage-1
trainers' checkpoints loaded back as first stages.

Tolerances: straight-through gradients within 1e-6 (relative, and of the
largest |g|); the training forward, its loss terms and BatchNorm's running
statistics within 1e-5; each gradient tensor within 1e-4 of its largest |g|;
one Adam step's parameters within 1e-3 * lr per element, plus what the
gradient tolerance allows through Adam's slope where |g| is near eps; ids
bit-equal. A bias whose shift a normalisation removes has a gradient of
rounding noise: it is held below 1e-5 of the model's largest gradient on
both sides instead of being compared (``*_SHIFT_INVARIANT``).
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from mage_tpu.compat import torch_export  # noqa: E402
from mage_tpu.models import autoencoder_kl as jkl  # noqa: E402
from mage_tpu.models.pipeline import MagePipeline as JaxPipeline  # noqa: E402
from mage_tpu.models.vqvae import VectorQuantizedVAE as JaxVQVAE  # noqa: E402
from mage_tpu.ops import codebook_lookup as jax_lookup  # noqa: E402
from mage_tpu.ops import vq_straight_through as jax_straight_through  # noqa: E402
from mage_tpu.training import vqvae_trainer as jtrainer  # noqa: E402
from mage_tpu_torch.compat import from_jax  # noqa: E402
from mage_tpu_torch.config import load_config  # noqa: E402
from mage_tpu_torch.models import autoencoder_kl as tkl  # noqa: E402
from mage_tpu_torch.models.pipeline import FirstStageKL, FirstStageVQVAE, MagePipeline  # noqa: E402
from mage_tpu_torch.models.vqvae import VectorQuantizedVAE  # noqa: E402
from mage_tpu_torch.ops import vq  # noqa: E402
from mage_tpu_torch.training import autoencoder_kl_trainer as kt  # noqa: E402
from mage_tpu_torch.training import vqvae_trainer as vt  # noqa: E402
from mage_tpu_torch.utils import trace  # noqa: E402

B, RES, DIM, K = 4, 32, 16, 32
CHANNELS = {4: 1, 8: 3}  # MNIST frames are grey, CATER's RGB
BETA, LR = 2.0, 1e-3
ST_TOL, FWD_TOL, GRAD_TOL, STEP_TOL = 1e-6, 1e-5, 1e-4, 1e-3
NOISE_TOL = 1e-5  # of the largest gradient: a bias that a normalisation removes
# 64 channels: two to each of GroupNorm's 32 groups, so no conv bias is removed
KL_DD = dict(ch=64, ch_mult=(1, 2), num_res_blocks=1, resolution=16, z_channels=4,
             embed_dim=4)
# biases whose gradient is rounding noise: each f4 conv bias feeding a
# BatchNorm, which subtracts the per-channel shift it adds; the KL-AE's
# attention key biases, which add one constant per query to every score
F4_SHIFT_INVARIANT = {"encoder.0.bias", "decoder.3.bias"} | {
    f"{side}.{i}.block.{j}.bias" for side, first in (("encoder", 4), ("decoder", 0))
    for i in (first, first + 1) for j in (1, 4)}
KL_SHIFT_INVARIANT = {"encoder.mid.attn_1.k.bias", "decoder.mid.attn_1.k.bias"}


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _frames(down_ratio, seed=0, batch=B):
    rng = np.random.RandomState(seed)
    return (rng.rand(batch, RES, RES, CHANNELS[down_ratio]) * 2 - 1).astype(np.float32)


def _close(got, want, tol=FWD_TOL, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())),
                               err_msg=err_msg)


@functools.cache
def _jax_vqvae(down_ratio):
    """A JAX VQ-VAE, its variables (its init runs a train-mode forward, so
    the f4 running statistics are not the defaults), and its jitted training
    forward, loss gradient and first ``make_tx`` Adam update, compiled once
    for the file."""
    jm = JaxVQVAE(input_dim=CHANNELS[down_ratio], down_ratio=down_ratio, dim=DIM, K=K)
    variables = jax.jit(lambda key: jm.init(key, jnp.asarray(_frames(down_ratio, 9)),
                                            train=True))(jax.random.PRNGKey(down_ratio))
    forward = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))
    grad = jax.jit(jax.grad(lambda p, s, x: jtrainer.loss_terms(jm, p, s, x, BETA, True),
                            has_aux=True))
    tx = jtrainer.make_tx(LR)
    adam = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))
    return jm, variables, forward, grad, adam


def _pair(down_ratio):
    """The JAX model and variables, and the port's model with them."""
    jm, variables = _jax_vqvae(down_ratio)[:2]
    tm = VectorQuantizedVAE(CHANNELS[down_ratio], down_ratio, DIM, K)
    from_jax.load(tm, from_jax.export_vqvae(variables, down_ratio))
    return jm, variables, tm


def _buffers(module):
    return {k: v.clone() for k, v in module.state_dict().items()
            if "running" in k or "num_batches" in k}


def _assert_running_stats(tm, batch_stats, params, down_ratio):
    want = from_jax.export_vqvae({"params": params, "batch_stats": batch_stats}, down_ratio)
    keys = [k for k in want if "running" in k]
    assert len(keys) == (2 * 10 if down_ratio == 4 else 0)  # f4: 10 BatchNorms
    for key in keys:
        _close(tm.state_dict()[key].numpy(), want[key], err_msg=key)


# ---- the straight-through quantizer (tests/test_vq.py's cases) ------------------


def _st_loss(case, quantize, lookup, z, cb, w, detach):
    codes, idx = quantize(z, detach(cb) if case != "analytic" else cb)
    if case == "analytic":
        return (codes * w).sum()
    if case == "detached":
        return (codes ** 2).sum()
    return (codes ** 2).sum() + 3.0 * (lookup(cb, idx) ** 2).sum()


@pytest.mark.parametrize("jax_impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("case", ["analytic", "detached", "reference"])
def test_straight_through_matches_jax(case, jax_impl):
    """Codes exact (the codebook rows of the ids, which are JAX's); the z and
    codebook gradients JAX's: the cotangent unchanged into z, its scatter-add
    into the chosen rows, none through a detached codebook."""
    z_np, cb_np, w_np = _rand((5, 4, 8), 5), _rand((16, 8), 6), _rand((5, 4, 8), 7)
    z_np[0, 0] = cb_np[3]  # codes 3 and 9 tie: the lower id wins
    cb_np[9] = cb_np[3]

    def jloss(z, cb):
        return _st_loss(case, lambda a, b: jax_straight_through(a, b, jax_impl), jax_lookup,
                        z, cb, jnp.asarray(w_np), jax.lax.stop_gradient)

    j_codes, j_idx = jax_straight_through(jnp.asarray(z_np), jnp.asarray(cb_np), jax_impl)
    j_gz, j_gcb = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(z_np), jnp.asarray(cb_np))

    z, cb = torch.from_numpy(z_np).requires_grad_(), torch.from_numpy(cb_np).requires_grad_()
    codes, idx = vq.vq_straight_through(z, cb)
    assert idx.dtype == torch.int32 and not idx.requires_grad and codes.shape == z.shape
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    assert int(idx[0, 0]) == 3
    np.testing.assert_array_equal(codes.detach().numpy(), np.asarray(j_codes))
    np.testing.assert_array_equal(codes.detach().numpy(), cb_np[idx.numpy()])
    loss = _st_loss(case, lambda a, b: vq.vq_straight_through(a, b), vq.codebook_lookup,
                    z, cb, torch.from_numpy(w_np), torch.Tensor.detach)
    gz, gcb = torch.autograd.grad(loss, (z, cb), allow_unused=True)
    if gcb is None:  # the detached codebook is not in the graph at all
        gcb = torch.zeros_like(cb)
    _close(gz.numpy(), j_gz, ST_TOL)
    _close(gcb.numpy(), j_gcb, ST_TOL)
    if case == "detached":
        assert not gcb.any()


# ---- the VQ-VAE forward, train step, eval step and restart ------------------


def test_carrier_matches_jax_exporter_vqvae_f4():
    """The f4 carrier (BatchNorm statistics, ResBlocks, transposed convs)
    equals the JAX exporter key for key and value for value."""
    _, variables, tm = _pair(4)
    ours = from_jax.export_vqvae(variables, 4)
    theirs = torch_export.export_vqvae(variables, down_ratio=4)
    assert sorted(ours) == sorted(theirs) == sorted(tm.state_dict())
    for key in ours:
        np.testing.assert_array_equal(np.asarray(ours[key]), np.asarray(theirs[key]),
                                      err_msg=key)


@pytest.mark.parametrize("down_ratio", [4, 8])
def test_train_forward_and_running_stats_match_jax(down_ratio):
    jm, variables, tm = _pair(down_ratio)
    x = _frames(down_ratio)
    (jx, jz, jq), mutated = _jax_vqvae(down_ratio)[2](variables, x)
    tm.train()
    tx, tz, tq = tm(torch.from_numpy(x))
    assert tx.shape == x.shape
    for got, want, name in ((tx, jx, "x_tilde"), (tz, jz, "z_e"), (tq, jq, "z_q_bar")):
        _close(got.detach().numpy(), want, err_msg=name)
    _assert_running_stats(tm, mutated.get("batch_stats", {}), variables["params"], down_ratio)
    # encode stays the eval-mode first stage's call, on the updated averages
    tm.eval()
    updated = {**variables, **mutated}
    want_ids = jax.jit(lambda v, x: jm.apply(v, x, method="encode"))(updated, x)
    np.testing.assert_array_equal(tm.encode(torch.from_numpy(x)).numpy(), np.asarray(want_ids))


@pytest.mark.parametrize("down_ratio", [4, 8])
def test_one_train_step_matches_jax(down_ratio):
    """Loss terms, every gradient, the running statistics and the parameters
    after one Adam step: the JAX side is its train step's pieces, the loss
    gradient and ``make_tx``'s optax update, the port's its train step."""
    jm, variables, tm = _pair(down_ratio)
    x = _frames(down_ratio, seed=1)
    params, stats = variables["params"], variables.get("batch_stats", {})
    _, _, _, grad, adam = _jax_vqvae(down_ratio)
    j_grads, (mutated, j_aux) = grad(params, stats, x)
    j_params = adam(j_grads, params)

    opt = vt.make_optimizer(tm, LR)
    aux = vt.make_train_step(tm, opt, BETA)(torch.from_numpy(x), LR)
    assert set(aux) == {"reconstruction", "quantization", "commitment", "total"}
    for key, value in aux.items():
        np.testing.assert_allclose(value.item(), float(j_aux[key]), rtol=FWD_TOL, err_msg=key)
    new_stats = mutated.get("batch_stats", {})
    want_g = from_jax.export_vqvae({"params": j_grads, "batch_stats": new_stats}, down_ratio)
    want_p = from_jax.export_vqvae({"params": j_params, "batch_stats": new_stats}, down_ratio)
    top = max(float(np.abs(np.asarray(want_g[k])).max()) for k, _ in tm.named_parameters())
    invariant = F4_SHIFT_INVARIANT if down_ratio == 4 else set()
    eps = opt.param_groups[0]["eps"]
    for key, p in tm.named_parameters():
        g, jg = p.grad.numpy(), np.asarray(want_g[key])
        if key in invariant:
            assert max(np.abs(g).max(), np.abs(jg).max()) <= NOISE_TOL * top, key
            continue
        np.testing.assert_allclose(g, jg, rtol=0, atol=GRAD_TOL * float(np.abs(jg).max()),
                                   err_msg=key)
        # Adam's first update is lr * g / (|g| + eps): a gradient difference
        # where |g| is near eps passes through amplified by eps / (|g| + eps)^2
        slack = eps * GRAD_TOL * np.abs(jg).max() / (np.abs(g) + eps) ** 2
        err = np.abs(p.detach().numpy() - np.asarray(want_p[key]))
        assert (err <= LR * (STEP_TOL + np.minimum(slack, 2.0))).all(), key
    _assert_running_stats(tm, new_stats, params, down_ratio)
    if down_ratio == 4:
        assert int(tm.encoder[1].num_batches_tracked) == 1


@pytest.mark.parametrize("step", ["eval", "reconstruct"])
def test_eval_and_reconstruct_match_jax_and_leave_running_stats(step):
    """Train-mode BatchNorm on the batch statistics, as JAX's steps run it,
    with the running averages bit-equal afterwards."""
    jm, variables, tm = _pair(4)
    x = _frames(4, seed=2)
    before = _buffers(tm)
    state = jtrainer.VQVAETrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                                     batch_stats=variables["batch_stats"], opt_state=None)
    if step == "eval":
        want = jtrainer.make_eval_step(jm, BETA)(state, x)
    else:
        want = jtrainer.make_reconstruct(jm)(state, x)
    got = (vt.make_eval_step(tm) if step == "eval" else vt.make_reconstruct(tm))(
        torch.from_numpy(x))
    if step == "eval":
        assert set(got) == set(want)
        for key in got:
            np.testing.assert_allclose(got[key].item(), float(want[key]), rtol=FWD_TOL)
    else:
        _close(got.numpy(), want)
    for key, value in _buffers(tm).items():
        assert torch.equal(value, before[key]), key


@pytest.mark.parametrize("down_ratio", [4, 8])
def test_restart_matches_jax_with_its_picks_and_noise(down_ratio):
    """The same dead codes re-seeded to the same encoder outputs plus noise;
    live codes and the running averages untouched."""
    jm, variables, tm = _pair(down_ratio)
    x = _frames(down_ratio, seed=3)
    rng = jax.random.PRNGKey(11)
    state = jtrainer.VQVAETrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables.get("batch_stats", {}), opt_state=None)
    j_state, j_dead = jtrainer.make_restart_dead_codes(jm)(state, x, rng)
    # the draws JAX's restart makes from rng
    n_tokens = B * (RES // down_ratio) ** 2
    d = tm.embed_dim
    rng_pick, rng_noise = jax.random.split(rng)
    pick = np.array(jax.random.randint(rng_pick, (K,), 0, n_tokens))
    noise = np.array(jax.random.normal(rng_noise, (K, d), jnp.float32))

    before = _buffers(tm)
    old = tm.codebook.embedding.weight.detach().clone()
    launches = trace.launch_counts().get("vq", 0)
    n_dead = vt.make_restart_dead_codes(tm)(torch.from_numpy(x), pick=torch.from_numpy(pick),
                                            noise=torch.from_numpy(noise))
    assert trace.launch_counts().get("vq", 0) == launches  # the CPU takes the plain version
    assert int(n_dead) == int(j_dead) and 0 < int(n_dead) < K
    new = tm.codebook.embedding.weight.detach()
    _close(new.numpy(), j_state.params["codebook"])
    live = (new == old).all(1)
    assert int((~live).sum()) == int(n_dead)
    for key, value in _buffers(tm).items():
        assert torch.equal(value, before[key]), key


# ---- the KL autoencoder ------------------------------------------------------


def _kl_frames(seed):
    return np.ascontiguousarray(_frames(8, seed=seed, batch=2)[:, :16, :16])


@functools.cache
def _jax_klae():
    """A JAX KL-AE, its params, frames, and its jitted loss gradient with
    the outputs, the noise from ``rng``, compiled once for the file."""
    jm = jkl.AutoencoderKL(**KL_DD)
    x = _kl_frames(4)
    variables = jax.jit(lambda key: jm.init({"params": key}, jnp.asarray(x),
                                            jax.random.PRNGKey(0)))(jax.random.PRNGKey(5))

    def loss(p, kl_weight, rng):
        recon, post = jm.apply({"params": p}, jnp.asarray(x), rng, train=True)
        rec = jnp.mean((recon - x) ** 2)
        kl = jnp.mean(post.kl())
        return rec + kl_weight * kl, (recon, {"reconstruction": rec, "kl": kl})

    return variables, x, jax.jit(jax.grad(loss, has_aux=True))


def _kl_pair():
    variables, x, _ = _jax_klae()
    tm = tkl.AutoencoderKL(**KL_DD)
    from_jax.load(tm, from_jax.export_autoencoder_kl(variables))
    return variables, tm, x


@pytest.mark.parametrize("kl_weight", [1e-6, 1.0])
def test_klae_forward_loss_and_gradients_match_jax(kl_weight):
    """The training forward and loss of ``train_autoencoder_kl.py`` with
    the posterior noise JAX draws passed in."""
    variables, tm, x = _kl_pair()
    rng = jax.random.PRNGKey(6)
    noise = np.array(jax.random.normal(rng, (2, 8, 8, KL_DD["z_channels"]), jnp.float32))
    j_grads, (j_recon, j_aux) = _jax_klae()[2](variables["params"], kl_weight, rng)
    tm.train()
    recon, posterior = tm(torch.from_numpy(x), torch.from_numpy(noise))
    _close(recon.detach().numpy(), j_recon)
    tm.zero_grad()
    loss, aux = kt.loss_terms(tm, torch.from_numpy(x), kl_weight, torch.from_numpy(noise))
    loss.backward()
    for key in ("reconstruction", "kl"):
        np.testing.assert_allclose(aux[key].item(), float(j_aux[key]), rtol=FWD_TOL,
                                   err_msg=key)
    want = from_jax.export_autoencoder_kl({"params": j_grads})
    top = max(float(np.abs(np.asarray(v)).max()) for v in want.values())
    for key, p in tm.named_parameters():
        g, jg = p.grad.numpy(), np.asarray(want[key])
        if key in KL_SHIFT_INVARIANT:
            assert max(np.abs(g).max(), np.abs(jg).max()) <= NOISE_TOL * top, key
            continue
        np.testing.assert_allclose(g, jg, rtol=0, atol=GRAD_TOL * float(np.abs(jg).max()),
                                   err_msg=key)


def test_klae_train_mode_takes_the_plain_chain(monkeypatch):
    """A train-mode forward never calls the fused op (JAX gates its kernel
    on ``not train``); the eval step sends both chains of every decoder
    ResnetBlock through it."""
    _, tm, x = _kl_pair()
    calls = []
    fused = tkl.gn_silu_conv3x3

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return fused(*args, **kwargs)

    monkeypatch.setattr(tkl, "gn_silu_conv3x3", counted)
    kt.make_train_step(tm, kt.make_optimizer(tm))(torch.from_numpy(x))
    assert calls == []
    n_blocks = sum(1 for m in tm.decoder.modules() if isinstance(m, tkl.ResnetBlock))
    terms = kt.make_eval_step(tm)(torch.from_numpy(x), generator=torch.Generator())
    assert len(calls) == 2 * n_blocks and not tm.training
    assert all(np.isfinite(float(v)) for v in terms.values())


# ---- the MNIST config's pipeline ---------------------------------------------


def test_mnist_config_generate_cached_ids_match_jax():
    """``config/mage_mnist.yaml`` (f4 first stage at its widths, 64-px
    frames) at a reduced depth: 3 frames, 1 text layer, 3 decoder layers.
    The JAX first stage's running statistics are redrawn, so the eval-mode
    encode reads real ones."""
    params = load_config("config/mage_mnist.yaml").model.params
    params.first_stage_config.params.pop("ckpt_path")
    params.frames_length = params.generate_decoder_config.params.frames_length = 3
    params.text_encoder_config.params.transformer_layers = 1
    params.generate_decoder_config.params.layers = 3
    rng = np.random.RandomState(0)
    text = np.zeros((1, 32), np.int32)
    text[0, :4] = [1, 7, 12, 2]
    batch = {"images": (rng.rand(1, 3, 64, 64, 1) - 0.5).astype(np.float32), "text": text,
             "speed": np.array([1.5], np.float32)}
    noise = rng.randn(1, 16, 16, 64).astype(np.float32)
    jp = JaxPipeline(**params)
    j_params = jp.init(jax.random.PRNGKey(0), batch)
    fs = jp.first_stage.variables
    fs["batch_stats"] = jax.tree_util.tree_map(
        lambda v: jnp.asarray(rng.rand(*v.shape).astype(np.float32) + 0.5), fs["batch_stats"])
    first = jnp.asarray(batch["images"][:, :1])
    lat0 = jp.encode_first_stage(first)
    j_ids = jax.jit(lambda p, *a: jp.core.apply({"params": p}, *a, method="generate_cached"))(
        j_params, lat0, jnp.asarray(text), jnp.asarray(batch["speed"]), jnp.asarray(noise))

    tp = MagePipeline(**params, device="cpu")
    assert tp.first_stage.model.down_ratio == 4
    from_jax.load_pipeline(tp, j_params, fs, text_layers=1, ma_layers=1, dec_layers=3)
    t_lat0 = tp.first_stage.encode(torch.from_numpy(batch["images"][:, :1]))
    np.testing.assert_array_equal(t_lat0.numpy(), np.asarray(lat0))
    t_ids = tp.core.generate_cached(t_lat0, torch.from_numpy(text),
                                    torch.from_numpy(batch["speed"]),
                                    video_noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))


# ---- the trainers' checkpoints -------------------------------------------------


def test_vqvae_trainer_checkpoint_loads_as_the_first_stage(tmp_path):
    """One epoch of ``VQVAETrainer`` (restart on, image grids on); its
    ``best`` strict-loads through the first stage's ``ckpt_path`` and
    ``resume`` restores weights, Adam and the step."""
    model = VectorQuantizedVAE(1, 4, DIM, K)
    trainer = vt.VQVAETrainer(model, lr=LR, log_dir=str(tmp_path / "log"),
                              ckpt_dir=str(tmp_path / "ckpt"), codebook_restart=True,
                              device="cpu")
    train = [_frames(4, seed=s) for s in (20, 21)]
    best = trainer.fit(train, [_frames(4, seed=22)], 1, fixed_images=_frames(4, seed=23))
    assert np.isfinite(best) and trainer.steps == 2
    assert (tmp_path / "ckpt" / "best").is_file() and (tmp_path / "ckpt" / "model_1").is_file()
    assert int(model.encoder[1].num_batches_tracked) == 2  # not the eval or restart passes
    config = {"input_dim": 1, "down_ratio": 4, "dim": DIM, "K": K,
              "ckpt_path": str(tmp_path / "ckpt" / "best")}
    loaded = FirstStageVQVAE.from_config(config).model
    for key, value in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[key], value), key

    again = vt.VQVAETrainer(VectorQuantizedVAE(1, 4, DIM, K), log_dir=str(tmp_path / "log2"),
                            ckpt_dir=str(tmp_path / "ckpt"), seed=1, device="cpu")
    again.init_state()
    again.resume("model_1")
    assert again.steps == 2
    for key, value in model.state_dict().items():
        assert torch.equal(again.model.state_dict()[key], value), key
    assert again.optimizer.state_dict()["state"].keys() == trainer.optimizer.state_dict()[
        "state"].keys()


def test_klae_trainer_checkpoint_loads_as_the_first_stage(tmp_path):
    dd = {k: v for k, v in KL_DD.items() if k != "embed_dim"}
    model = tkl.AutoencoderKL(**KL_DD)
    trainer = kt.KLAETrainer(model, log_dir=str(tmp_path / "log"),
                             ckpt_dir=str(tmp_path / "ckpt"), device="cpu")
    frames = [_kl_frames(s) for s in (30, 31)]
    best = trainer.fit(frames, frames[:1], 1)
    assert np.isfinite(best) and trainer.steps == 2
    loaded = FirstStageKL.from_config({"embed_dim": 4, "ddconfig": dd,
                                       "ckpt_path": str(tmp_path / "ckpt" / "best")}).model
    for key, value in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[key], value), key


def test_stage1_trainers_default_to_the_gpu(monkeypatch, tmp_path):
    """Without ``device`` the trainers run on the card, and raise without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dirs = dict(log_dir=str(tmp_path / "log"), ckpt_dir=str(tmp_path / "ckpt"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vt.VQVAETrainer(VectorQuantizedVAE(1, 4, DIM, K), **dirs)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kt.KLAETrainer(tkl.AutoencoderKL(**KL_DD), **dirs)
