"""Data, tensor and FSDP parallelism in the port, on the CPU over gloo.

- The placement decisions equal the JAX package's, element for element: the
  JAX ``shard_params`` placement of a tiny MAGE core, written as each
  element's (data shard, model shard) label and carried into the port's
  layout by ``compat.from_jax``, is the port's ``plan`` on the same core.
- One Adam step of that tiny MAGE on 2 ranks (data parallel) and on 4
  (data x model x FSDP) ends with every parameter within 1e-5 of the
  single-process port step on the global batch (which
  ``test_torch_port_train.py`` holds to JAX); the loss terms within 1e-5
  relative. A whole checkpoint saved from rank 0 restores onto the live
  placement exactly; batch-parallel cached generation gives the
  single-process ids.
- A 2-rank VQ-VAE step with BatchNorm (statistics over the global batch)
  equals the single-process step within 1e-5, and so does a dead-code
  restart.
- The dryrun twin runs on 4 gloo ranks and reports FSDP and TP placements.
- With four cards, the 4-rank steps run over nccl against the one-card step.

The ranks are spawned processes with a free port and a time limit.
"""

import math
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mage_tpu_torch.config import Config
from mage_tpu_torch.parallel import dryrun, gather_batch, make_mesh, shard_batch
from mage_tpu_torch.parallel import partitioning as part
from mage_tpu_torch.training import mage_trainer as mt
from mage_tpu_torch.training import vqvae_trainer as vt

TOL = 1e-5
LR = 1e-3
GLOBAL_B = 8
TIMEOUT = 240.0


@pytest.fixture(scope="module", autouse=True)
def keep_global_torch_rng():
    """Leave torch's global generator as this module found it: tests in
    other files draw from it unseeded, so their draws must not depend on
    whether this module ran first in their worker."""
    with torch.random.fork_rng():
        yield


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The single-process reference steps on one thread: the spawned ranks
    and the other test workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _init(rank, n, port, device_type="cpu"):
    """Join the test's process group: gloo on the CPU (one thread a rank), or
    nccl with card ``rank`` (TF32 off) -> this rank's device."""
    if device_type == "cpu":
        torch.set_num_threads(1)
        device = torch.device("cpu")
    else:
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo" if device_type == "cpu" else "nccl",
                            init_method=f"tcp://localhost:{port}", rank=rank, world_size=n)
    return device


def _global_inputs(pipe):
    batch = dryrun.tiny_batch(pipe, GLOBAL_B)
    rng = np.random.RandomState(11)
    r = pipe.core.image_resolution
    noise = rng.randn(GLOBAL_B, r, r, 64).astype(np.float32)
    video_noise = rng.randn(GLOBAL_B, r, r, 64).astype(np.float32)
    return batch, noise, video_noise


def _cfg(fsdp):
    return Config({"epoch": 1, "batchsize": GLOBAL_B, "lr": LR, "checkpoint_every": 10,
                   "fsdp": fsdp, "fsdp_min_size": 1024})


def _mage_worker(rank, n, port, axes, fsdp, out, device_type="cpu"):
    from torch.distributed.tensor import DTensor

    device = _init(rank, n, port, device_type)
    try:
        mesh = make_mesh(axes, device_type)
        pipe = dryrun.tiny_pipeline(device, dropout=0.0)
        trainer = mt.MageTrainer(pipe, _cfg(fsdp), f"{out}/ckpt", mesh=mesh)
        trainer.init_state()
        batch, noise, video_noise = _global_inputs(pipe)
        local = shard_batch(batch, mesh, device=device)
        terms = trainer.train_step(local, LR, trainer.beta, pipe.alpha,
                                   posterior_noise=shard_batch(noise, mesh, device=device))
        # the frozen first stage stays whole on every rank, outside the placement
        assert not any(isinstance(p, DTensor) for p in pipe.first_stage.model.parameters())
        state = trainer._state()
        if rank == 0:
            trainer.ckpt.save("step1", state)
        dist.barrier()
        # a fresh trainer on other weights restores the whole checkpoint
        # onto its live placement
        other = mt.MageTrainer(dryrun.tiny_pipeline(device, dropout=0.0, seed=5), _cfg(fsdp),
                               f"{out}/ckpt2", mesh=mesh)
        other.init_state()
        other.resume(trainer.ckpt.path("step1"))
        restored = other._state()
        same_model = all(torch.equal(v, restored["model"][k]) for k, v in state["model"].items())
        # (Adam keeps a fresh step count on the host and a restored one where
        # the checkpoint was mapped)
        same_moments = all(
            torch.equal(v.cpu(), restored["optimizer"]["state"][i][k].cpu())
            for i, st in state["optimizer"]["state"].items() for k, v in st.items())
        local_masters = all(isinstance(m, DTensor) for m, _ in other.masters.values())
        # batch-parallel cached generation on the trained weights
        trainer.sync_module()
        with torch.no_grad():
            lat0 = pipe.encode_first_stage(local["images"][:, :1])
            ids = pipe.core.generate_cached(
                lat0, local["text"], local["speed"],
                video_noise=shard_batch(video_noise, mesh, device=device))
        ids = gather_batch(ids, mesh)
        if rank == 0:
            torch.save({"model": {k: v.cpu() for k, v in state["model"].items()},
                        "terms": {k: float(v) for k, v in terms.items()},
                        "summary": part.sharding_summary(trainer.masters),
                        "restored": same_model and same_moments and local_masters,
                        "ids": ids.cpu(), "local_rows": local["text"].shape[0]},
                       f"{out}/result.pt")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("n, axes, fsdp", [
    (2, {"data": 2}, False),
    (4, {"data": 2, "model": 2}, True),
], ids=["dp2", "dp2_tp2_fsdp"])
def test_mage_step_on_ranks_matches_the_single_process_step(n, axes, fsdp, tmp_path):
    _hold_ranks_to_one_process(n, axes, fsdp, tmp_path, "cpu")


@pytest.fixture()
def four_cards():
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")


@pytest.mark.parametrize("axes", [{"data": 4}, {"data": 2, "model": 2}],
                         ids=["dp4_fsdp", "dp2_tp2_fsdp"])
def test_mage_step_on_four_cards_over_nccl_matches_the_one_card_step(four_cards, axes,
                                                                     tmp_path):
    """The same step as above over nccl, one card a rank, against the step on
    one card (f32, TF32 off)."""
    _hold_ranks_to_one_process(4, axes, True, tmp_path, "cuda")


def _dropout_worker(rank, n, port, axes, out):
    device = _init(rank, n, port)
    try:
        mesh = make_mesh(axes, "cpu")
        pipe = dryrun.tiny_pipeline(device, dropout=0.5)
        trainer = mt.MageTrainer(pipe, _cfg(False), f"{out}/ckpt", mesh=mesh)
        trainer.init_state()
        masks = []
        drop = next(m for m in pipe.core.modules()
                    if isinstance(m, torch.nn.Dropout) and m.p > 0)
        drop.register_forward_hook(lambda m, i, o: masks.append((o == 0).float()))
        # every rank gets the same rows: only the generators can tell them apart
        batch, noise, _ = _global_inputs(pipe)
        per = GLOBAL_B // axes.get("data", 1)
        trainer.train_step({k: torch.as_tensor(v[:per]) for k, v in batch.items()},
                           LR, trainer.beta, pipe.alpha,
                           posterior_noise=torch.from_numpy(noise[:per]))
        gathered = [torch.empty_like(masks[0]) for _ in range(n)]
        dist.all_gather(gathered, masks[0])
        if rank == 0:
            torch.save({"equal": torch.equal(gathered[0], gathered[1]),
                        "dropped": float(gathered[0].mean())}, f"{out}/masks.pt")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("axes, equal", [({"data": 2}, False), ({"model": 2}, True)],
                         ids=["data_ranks_differ", "model_ranks_agree"])
def test_dropout_masks_differ_over_data_and_agree_over_model(axes, equal, tmp_path):
    """Each data coordinate draws its own dropout masks, as each example of
    a global batch does in one process; the ranks of one coordinate, which
    run the same forward, draw the same."""
    dryrun.spawn(_dropout_worker, (2, dryrun.free_port(), axes, str(tmp_path)), 2,
                 timeout=TIMEOUT)
    got = torch.load(tmp_path / "masks.pt")
    assert 0.3 < got["dropped"] < 0.7
    assert got["equal"] == equal


def _hold_ranks_to_one_process(n, axes, fsdp, tmp_path, device_type):
    """One step on ``n`` spawned ranks against the one-process step on the
    global batch, on ``device_type``: loss terms within 1e-5 relative, every
    parameter within 1e-5, the whole checkpoint restored exactly (onto the
    placement and into a one-process trainer), batch-parallel ids equal."""
    device = torch.device("cuda", 0) if device_type == "cuda" else torch.device("cpu")
    if device_type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    pipe = dryrun.tiny_pipeline(device, dropout=0.0)
    batch, noise, video_noise = _global_inputs(pipe)
    step = mt.make_mage_train_step(pipe, mt.make_mage_optimizer(pipe.core))
    want = step(batch, LR, pipe.beta, pipe.alpha,
                posterior_noise=torch.from_numpy(noise).to(device))
    dryrun.spawn(_mage_worker, (n, dryrun.free_port(), axes, fsdp, str(tmp_path),
                                device_type), n, timeout=TIMEOUT)
    got = torch.load(tmp_path / "result.pt", weights_only=False)
    assert got["local_rows"] == GLOBAL_B // axes["data"]
    assert got["restored"]
    for key, value in want.items():
        np.testing.assert_allclose(float(got["terms"][key]), float(value), rtol=TOL,
                                   err_msg=key)
    for key, value in pipe.core.state_dict().items():
        torch.testing.assert_close(got["model"][key], value.cpu(), rtol=0, atol=TOL, msg=key)
    summary = got["summary"]
    if "model" in axes:
        assert summary["model"] > 0 and summary["data"] > 0
    elif fsdp:
        assert summary["model"] == 0 and summary["data"] > 0
    else:
        assert summary == {"model": 0, "data": 0,
                           "replicated": len(list(pipe.core.parameters()))}
    # the whole checkpoint also loads into a single-process trainer
    single = mt.MageTrainer(pipe, _cfg(False), str(tmp_path / "single"))
    single.init_state()
    single.resume(str(tmp_path / "ckpt" / "step1"))
    for key, value in got["model"].items():
        torch.testing.assert_close(pipe.core.state_dict()[key].cpu(), value, rtol=0, atol=0)
    with torch.no_grad():
        lat0 = pipe.encode_first_stage(batch["images"][:, :1])
        ids = pipe.core.generate_cached(lat0, torch.from_numpy(batch["text"]).to(device),
                                        torch.from_numpy(batch["speed"]).to(device),
                                        video_noise=torch.from_numpy(video_noise).to(device))
    torch.testing.assert_close(got["ids"], ids.cpu(), rtol=0, atol=0)


def _vq_images():
    return np.random.RandomState(2).rand(GLOBAL_B, 32, 32, 1).astype(np.float32) - 0.5


def _vq_trainer(out, mesh=None):
    from mage_tpu_torch.models.vqvae import VectorQuantizedVAE

    model = VectorQuantizedVAE(input_dim=1, down_ratio=4, dim=16, K=32)
    trainer = vt.VQVAETrainer(model, lr=LR, log_dir=f"{out}/log", ckpt_dir=f"{out}/ckpt",
                              codebook_restart=True, device="cpu", mesh=mesh)
    trainer.init_state()
    return trainer


def _restart_draws():
    g = torch.Generator().manual_seed(3)
    return torch.randint(0, GLOBAL_B * 64, (32,), generator=g), torch.randn(32, 16, generator=g)


def _vqvae_worker(rank, n, port, out):
    _init(rank, n, port)
    try:
        mesh = make_mesh(None, "cpu")
        trainer = _vq_trainer(f"{out}/rank{rank}", mesh)
        local = shard_batch(_vq_images(), mesh)
        aux = trainer.train_step(local, LR)
        evals = {k: pmean for k, pmean in trainer.evaluate([local]).items()}
        pick, noise = _restart_draws()
        dead = trainer.restart_dead(local, pick=pick, noise=noise)
        if rank == 0:
            torch.save({"model": trainer.model.state_dict(), "aux": aux, "evals": evals,
                        "dead": dead}, f"{out}/result.pt")
    finally:
        dist.destroy_process_group()


def test_vqvae_step_with_batchnorm_on_two_ranks_matches_the_global_batch(tmp_path):
    dryrun.spawn(_vqvae_worker, (2, dryrun.free_port(), str(tmp_path)), 2, timeout=TIMEOUT)
    got = torch.load(tmp_path / "result.pt", weights_only=False)
    trainer = _vq_trainer(str(tmp_path / "single"))
    images = torch.from_numpy(_vq_images())
    aux = trainer.train_step(images, LR)
    for key, value in aux.items():
        np.testing.assert_allclose(float(got["aux"][key]), float(value), rtol=TOL, err_msg=key)
    # evaluate averages per-rank batch means: the same global mean here
    for key, value in trainer.evaluate([images]).items():
        np.testing.assert_allclose(got["evals"][key], value, rtol=TOL, err_msg=key)
    pick, noise = _restart_draws()
    assert int(got["dead"]) == int(trainer.restart_dead(images, pick=pick, noise=noise))
    shift_invariant = _biases_before_batchnorm(trainer.model)
    assert len(shift_invariant) == 10  # two strided convs, two per ResBlock
    for key, value in trainer.model.state_dict().items():
        if key in shift_invariant:
            # a bias that BatchNorm's batch mean cancels has a zero gradient
            # up to rounding, so Adam's first step moves it by +-lr on the
            # rounding's sign, in either run
            assert (got["model"][key] - value).abs().max() <= 2 * LR + TOL, key
            continue
        torch.testing.assert_close(got["model"][key].to(value.dtype), value, rtol=0,
                                   atol=TOL, msg=key)


def _biases_before_batchnorm(model) -> set:
    from mage_tpu_torch.models.vqvae import BatchNorm2d

    out = set()
    for name, seq in model.named_modules():
        if isinstance(seq, torch.nn.Sequential):
            mods = list(seq.named_children())
            for (a, conv), (_, nxt) in zip(mods, mods[1:]):
                if isinstance(nxt, BatchNorm2d) and getattr(conv, "bias", None) is not None:
                    out.add(f"{name}.{a}.bias")
    return out


def _labels(shape, spec, sizes):
    """Each element's owner, data shard * model size + model shard."""
    label = np.zeros(shape, np.int64)
    tp = sizes.get("model", 1)
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        idx = np.arange(shape[dim]) // (shape[dim] // sizes[axis])
        idx = idx.reshape([-1 if d == dim else 1 for d in range(len(shape))])
        label = label + (idx * tp if axis == "data" else idx)
    return label


@pytest.fixture(scope="module")
def jax_tiny_params():
    """The params of ``__graft_entry__``'s tiny JAX pipeline (the dryrun's)."""
    jax = pytest.importorskip("jax")
    import __graft_entry__ as graft

    jp = graft._tiny_pipeline()
    return jp.init(jax.random.PRNGKey(0), graft._batch(jp, 2, 32, 32, 1))


@pytest.mark.parametrize("sizes, fsdp_min", [
    ({"data": 2, "model": 2}, 1024),
    ({"data": 4, "model": 1}, 1024),
    ({"data": 1, "model": 2}, None),
    ({"data": 4, "model": 2}, None),
], ids=["dp2_tp2_fsdp1024", "dp4_fsdp1024", "tp2", "dp4_tp2_fsdp_default"])
def test_placement_decisions_equal_jax_element_for_element(sizes, fsdp_min, jax_tiny_params):
    import jax

    from mage_tpu.parallel import make_mesh as jax_make_mesh
    from mage_tpu.parallel.partitioning import shard_params
    from mage_tpu_torch.compat import from_jax

    params = jax_tiny_params
    n = sizes["data"] * sizes["model"]
    mesh = jax_make_mesh(dict(sizes), devices=jax.devices()[:n])
    placed = shard_params(params, mesh, fsdp_axis="data", fsdp_min_size=fsdp_min)
    labels = jax.tree_util.tree_map(
        lambda x: _labels(x.shape, tuple(x.sharding.spec) + (None,) * (x.ndim - len(
            x.sharding.spec)), sizes), placed)
    want = from_jax.export_mage_core(labels, randomness=True, text_layers=1, ma_layers=1,
                                     dec_layers=3)

    core = dryrun.tiny_pipeline("cpu").core
    plan = part.plan(core, sizes, fsdp_axis="data", fsdp_min_size=fsdp_min)
    assert set(plan) == {k for k, _ in core.named_parameters()}
    n_split = 0
    for name, (layout, spec) in plan.items():
        shape = tuple(layout.to_view(core.get_parameter(name)).shape)
        got = layout.from_view(torch.from_numpy(_labels(shape, spec, sizes))).numpy()
        n_split += int(got.any())
        if ".ln_q." in name or ".ln_kv." in name:
            # MAGE runs no ln_q/ln_kv: the carrier writes identities there
            assert not got.any(), name
            continue
        np.testing.assert_array_equal(got, want[name], err_msg=name)
    assert n_split > 0


@pytest.mark.parametrize("shape, spec, size, want", [
    ((512, 256), (), 4, ("data", None)),
    ((512, 8, 64), (None, "model", None), 4, ("data", "model", None)),
    ((64,), (), 4, ()),
    ((513, 255), (), 4, ()),
    ((3, 3, 512, 512), (), 2, (None, None, "data", None)),
])
def test_spec_rules_equal_jax(shape, spec, size, want):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from mage_tpu.parallel import partitioning as jax_part

    got = part.fsdp_extend_spec(spec, shape, size)
    assert got == want
    assert tuple(jax_part.fsdp_extend_spec(P(*spec), jnp.zeros(shape), size)) == got
    for name, jax_path, view in [
        ("blocks.0.attn.in_proj_weight", "['attn']['q_proj']['kernel']", (64, 2, 32)),
        ("blocks.0.attn.out_proj.weight", "['attn']['out_proj']['kernel']", (2, 32, 64)),
        ("blocks.0.mlp.c_fc.weight", "['mlp']['c_fc']['kernel']", (64, 256)),
        ("blocks.0.mlp.c_proj.weight", "['mlp']['c_proj']['kernel']", (256, 64)),
        ("blocks.0.mlp.c_fc.bias", "['mlp']['c_fc']['bias']", (64,)),
        ("conv.0.weight", "['conv']['kernel']", (8, 8)),
    ]:
        j = tuple(jax_part.param_spec(jax_path, jnp.zeros(view)))
        assert part.param_spec(name, view) == j + (None,) * (len(view) - len(j)), name


def test_mesh_shapes_and_errors_follow_jax(tmp_path):
    port = dryrun.free_port()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(None, "cpu")
        assert mesh.mesh_dim_names == ("data",) and mesh.shape == (1,)
        with pytest.raises(ValueError, match="Only one mesh axis may be -1"):
            make_mesh({"data": -1, "model": -1}, "cpu")
        with pytest.raises(ValueError, match="not divisible by 2"):
            make_mesh({"data": -1, "model": 2}, "cpu")
        with pytest.raises(ValueError, match="Mesh size 2 != device count 1"):
            make_mesh({"data": 2}, "cpu")
        x = torch.arange(6)
        assert torch.equal(shard_batch({"x": x}, mesh)["x"], x)
        assert torch.equal(gather_batch(x, mesh), x)
    finally:
        dist.destroy_process_group()


def test_sharded_loaders_give_disjoint_shards():
    from mage_tpu_torch.data.loader import Loader

    data = [{"i": np.array(i)} for i in range(20)]
    seen = []
    for index in range(4):
        loader = Loader(data, 2, shuffle=True, seed=1, drop_last=True, num_shards=4,
                        shard_index=index)
        seen.append({int(i) for b in loader for i in b["i"]})
    assert all(len(s) == 4 for s in seen)
    assert len(set().union(*seen)) == 16
    assert all(a.isdisjoint(b) for i, a in enumerate(seen) for b in seen[i + 1:])


def test_dryrun_on_four_gloo_ranks_reports_fsdp_and_tp(capfd):
    dryrun.main(["--devices", "4", "--device", "cpu"])
    out = capfd.readouterr().out
    assert "mesh: {'data': 2, 'model': 2}" in out
    line = next(x for x in out.splitlines() if x.startswith("dryrun_multichip(4): ok"))
    fsdp, tp = (int(v) for v in (line.split("data-sharded=")[1].split()[0],
                                 line.split("model-sharded=")[1].split()[0]))
    assert fsdp > 0 and tp > 0
    assert math.isfinite(float(line.split("loss=")[1].split(",")[0]))


def test_parallel_entry_points_default_to_the_gpu(monkeypatch):
    from mage_tpu_torch.parallel import init_distributed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.main(["--devices", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_distributed()


def _cli_worker(rank, n, ports, tmp, cfg):
    import os

    from mage_tpu_torch.cli import main_mage, train_vqvae

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(ports[0]))
    train_vqvae.main(["--data-root", f"{tmp}/mnist_single_20f_10k_", "--dataset", "mnist",
                      "--batch-size", "8", "--num-epochs", "1", "--lr", "1e-3",
                      "--hidden-size", "16", "--k", "8", "--output-folder", "t",
                      "--log-folder", f"{tmp}/logs", "--model-folder", f"{tmp}/models",
                      "--log-every", "1", "--device", "cpu", "--multihost"])
    os.environ["MASTER_PORT"] = str(ports[1])
    main_mage.main(["--config", cfg, "--split", "train", "--checkpoint-path", f"{tmp}/ckpt",
                    "--device", "cpu", "--multihost"])


def test_clis_train_data_parallel_under_multihost(tmp_path):
    """Both CLIs with ``--multihost`` on 2 gloo ranks (the environment
    ``torchrun`` sets): each rank takes half of the global batch from its
    own shard, and rank 0 alone writes the snapshot, logs and checkpoints."""
    import json

    from test_torch_port_cli import MAGE_YAML

    from mage_tpu_torch.data.generators.mnist_single import main as gen_main

    gen_main(["--out", str(tmp_path), "--num-train", "16", "--num-val", "8", "--seed", "1"])
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(MAGE_YAML.format(root=tmp_path, ckpt=tmp_path / "models" / "t" / "best"))
    dryrun.spawn(_cli_worker, (2, (dryrun.free_port(), dryrun.free_port()), str(tmp_path),
                               str(cfg)), 2, timeout=TIMEOUT)
    assert (tmp_path / "models" / "t" / "best").is_file()
    # 16 clips over 2 shards at 4 a rank: 2 steps, each logged once
    lines = (tmp_path / "logs" / "t" / "metrics.jsonl").read_text().splitlines()
    steps = [json.loads(x)["step"] for x in lines if "loss/train/total" in x]
    assert steps == [1, 2]
    ckpt = tmp_path / "ckpt"
    assert {"config.yaml", "iteration_2", "model_best", "trainer_state.json"} <= set(
        os.listdir(ckpt))
    restored = torch.load(ckpt / "iteration_2", weights_only=True)
    assert restored["step"] == 2
    assert json.loads((ckpt / "trainer_state.json").read_text())["iteration"] == 2
