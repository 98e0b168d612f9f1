"""Stage-2 MAGE trainer: first-stage encode, teacher-forced forward and
backward, and the Adam update, on one device.

Port of ``mage_tpu/training/mage_trainer.py``:

- Adam with betas (0.9, 0.98) and eps 1e-6, per-epoch cosine or milestone
  learning rate (``lr.epoch_lr``).
- Mixed precision as the JAX step does it: with ``compute_dtype`` every f32
  parameter enters the forward as a copy in that dtype
  (``torch.func.functional_call``), so the forward and backward run in it,
  while the f32 masters, the Adam state and every loss reduction stay f32
  and the gradients come back f32 through the casts. The frozen first stage
  keeps its own precision.
- MAGE+ auto-beta inside the step: beta_t is computed by ``pid.pid_update``
  on this step's detached KL, on the device, and weights this step's loss
  as a constant; the (3,) controller state comes back as
  ``terms["_pid_state"]``.
- Scalar logging per iteration under the reference's ``train/``/``val/``
  tags, and every ``checkpoint_every`` iterations a validation pass,
  ``iteration_N`` and ``model_best`` checkpoints and a ``trainer_state.json``
  sidecar (iteration, best loss, beta, the PID state) that ``resume`` reads.

Dropout draws from torch's default generator (seeded per ``data``
coordinate under a mesh); the posterior and KL-AE noise from the
``generator`` passed to a step.

With a ``mesh`` (``parallel.make_mesh``; one process per device, each fed
its slice of the global batch) the trainer places the core's parameters as
the JAX trainer does: split over the ``model`` axis by its tensor-parallel
rules when the mesh has one, and with ``train.fsdp`` over the ``data``
axis too (ZeRO-3, tensors of at least ``train.fsdp_min_size`` elements),
else replicated, whose gradients are averaged over the ``data`` axis as DDP
does (``parallel.partitioning``). The train step runs the model axis'
split weights as shards, so the axis splits the attention heads' and the
MLPs' matmuls (``parallel.tensor_parallel``); evaluation runs them whole.
The placed masters then hold the parameters (the core's own are emptied
until ``sync_module``). Loss terms, the PID's KL and validation means are
the global batch's. Checkpoints are saved whole from rank 0 and restored
onto the live placement; only rank 0 writes logs.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Any, Callable, Iterable, Mapping, Optional

import torch

from mage_tpu_torch.models.pipeline import MagePipeline
from mage_tpu_torch.parallel import mesh as pmesh
from mage_tpu_torch.parallel import partitioning, tensor_parallel
from mage_tpu_torch.training.checkpoint import Checkpointer
from mage_tpu_torch.training.lr import epoch_lr
from mage_tpu_torch.training.pid import initial_pid_state, pid_update
from mage_tpu_torch.utils import MetricsWriter, Timer, trace
from mage_tpu_torch.utils.metrics import NullWriter

HOST_STATE = "trainer_state.json"


def make_mage_optimizer(core: Optional[torch.nn.Module], lr: float = 1e-4,
                        params: Optional[Iterable[torch.Tensor]] = None) -> torch.optim.Adam:
    """Adam over the core's parameters (or ``params``, a placement's
    masters); the train step sets its rate."""
    params = core.parameters() if params is None else params
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.98), eps=1e-6)


def cast_floating(params: Mapping[str, torch.Tensor], dtype: torch.dtype) -> dict:
    """f32 tensors -> ``dtype`` copies (mixed-precision compute copies,
    through which gradients flow back to the f32 tensors); others pass."""
    return {k: v.to(dtype) if v.dtype == torch.float32 else v for k, v in params.items()}


def train_loss(pipeline: MagePipeline, terms: dict, beta, alpha,
               mean: Callable = lambda x: x) -> torch.Tensor:
    """The step's loss from the raw terms, with ``terms`` completed in place:
    ``prediction``, plus, on the stochastic branch, beta * KL and
    alpha * speed_l2 for a fixed ``beta``, or, under auto-beta, beta_t * KL
    with beta_t = PID(this step's KL) from the (3,) controller state
    ``beta``; ``terms`` then gains ``beta`` and ``_pid_state``. ``mean``
    turns a rank's KL into the global batch's for the PID (data
    parallelism)."""
    final = terms["prediction"]
    if pipeline.randomness:
        if pipeline.auto_beta:
            beta_t, new_pid = pid_update(beta, pipeline.v_kl, mean(terms["kl_loss"].detach()))
            final = final + beta_t.to(final.dtype) * terms["kl_loss"]
            terms["beta"] = beta_t
            terms["_pid_state"] = new_pid
        else:
            final = final + beta * terms["kl_loss"]
            final = final + alpha * terms.get("speed_l2", 0.0)
    terms["final_loss"] = final
    return final


def make_mage_train_step(pipeline: MagePipeline, optimizer: torch.optim.Optimizer,
                         compute_dtype: Optional[torch.dtype] = None,
                         loss: Callable = train_loss,
                         params_fn: Optional[Callable[[], dict]] = None):
    """-> ``train_step(batch, lr, beta, alpha, generator=None,
    posterior_noise=None, first_stage_noise=None)``: one update of the
    core's parameters in place; returns the detached terms. ``beta`` is the
    fixed KL weight, or under auto-beta the (3,) PID state. After the call
    each parameter's ``grad`` holds this step's gradient. ``loss(pipeline,
    terms, beta, alpha)`` makes the step's loss from the raw terms
    (``train_loss``, or the e2e chains' own weighting). ``params_fn()``
    gives the core's parameters for the forward (a placement's gathered
    masters) in place of its own. Each step is the root span
    ``mage.train_step`` of ``utils.trace``, over ``mage.cast``,
    ``mage.forward``, ``mage.backward`` and ``mage.adam``; it is timed, so
    every step's spans carry their device milliseconds."""
    core = pipeline.core

    def train_step(batch: Mapping[str, Any], lr: float, beta, alpha: float,
                   generator: Optional[torch.Generator] = None,
                   posterior_noise=None, first_stage_noise=None) -> dict:
        with trace.span("mage.train_step", timed=True):
            for group in optimizer.param_groups:
                group["lr"] = lr
            optimizer.zero_grad(set_to_none=True)
            with trace.span("mage.cast"):
                params = _forward_params(core, compute_dtype, params_fn)
            with trace.span("mage.forward"):
                terms = pipeline.loss_terms(
                    batch, train=True, params=params, compute_dtype=compute_dtype,
                    generator=generator, posterior_noise=posterior_noise,
                    first_stage_noise=first_stage_noise)
                final = loss(pipeline, terms, beta, alpha)
            with trace.span("mage.backward"):
                final.backward()
            with trace.span("mage.adam"):
                optimizer.step()
            return {k: v.detach() for k, v in terms.items()}

    return train_step


def _forward_params(core, compute_dtype, params_fn) -> Optional[dict]:
    """The tensors the forward runs the core on: ``params_fn()``'s or the
    core's own, cast to ``compute_dtype``; None for the core's own as they are."""
    params = None if params_fn is None else params_fn()
    if compute_dtype is not None:
        params = cast_floating(params or dict(core.named_parameters()), compute_dtype)
    return params


def make_mage_eval_step(pipeline: MagePipeline, compute_dtype: Optional[torch.dtype] = None,
                        test_flag: bool = False,
                        params_fn: Optional[Callable[[], dict]] = None):
    """-> ``eval_step(batch, beta, alpha, generator=None, posterior_noise=
    None, video_noise=None, first_stage_noise=None)``: the loss terms in eval
    mode without gradients, with ``final_loss`` = prediction + beta * KL
    (+ alpha * speed_l2 for a fixed beta); ``beta`` is a number here.
    ``test_flag`` samples the stochastic branch's prior instead of its
    posterior; ``params_fn`` as for the train step."""
    core = pipeline.core

    @torch.no_grad()
    def eval_step(batch: Mapping[str, Any], beta: float, alpha: float,
                  generator: Optional[torch.Generator] = None,
                  posterior_noise=None, video_noise=None, first_stage_noise=None) -> dict:
        params = _forward_params(core, compute_dtype, params_fn)
        terms = pipeline.loss_terms(
            batch, train=False, test_flag=test_flag, params=params,
            compute_dtype=compute_dtype, generator=generator,
            posterior_noise=posterior_noise, video_noise=video_noise,
            first_stage_noise=first_stage_noise)
        final = terms["prediction"]
        if pipeline.randomness:
            final = final + beta * terms["kl_loss"]
            if not pipeline.auto_beta:
                final = final + alpha * terms.get("speed_l2", 0.0)
        terms["final_loss"] = final
        return terms

    return eval_step


class MageTrainer:
    """The training loop over ``pipeline``'s core. ``train_cfg`` is the
    config's ``train`` section (``epoch``, ``lr``, ``cos``, ``lr_steps``,
    ``lr_gamma``, ``checkpoint_every``, ``bf16``, and with a ``mesh``
    ``fsdp`` and ``fsdp_min_size``); checkpoints, the metrics log and the
    sidecar go to ``checkpoint_path``. With a ``mesh`` the loaders give each
    rank its slice of the global batch (``parallel.shard_batch``, or loaders
    sharded over the ``data`` axis)."""

    def __init__(self, pipeline: MagePipeline, train_cfg: Mapping[str, Any],
                 checkpoint_path: str, mesh=None, seed: int = 0):
        self.pipeline = pipeline
        self.cfg = train_cfg
        self.mesh = mesh
        # train.bf16: true -> the mixed-precision step
        self.compute_dtype = torch.bfloat16 if bool(train_cfg.get("bf16", False)) else None
        self.ckpt = Checkpointer(checkpoint_path)
        self.writer = (MetricsWriter(checkpoint_path) if pmesh.is_main_rank(mesh)
                       else NullWriter())
        self.seed = seed
        self.masters: Optional[dict] = None
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.train_step = None
        self.eval_step = make_mage_eval_step(pipeline, self.compute_dtype)
        # auto-beta: the PID runs in the step; the trainer carries its state
        # and mirrors the latest beta on the host for eval, logging and resume
        self.pid_state = initial_pid_state(pipeline.device) if pipeline.auto_beta else None
        self.beta = 0.0 if pipeline.auto_beta else pipeline.beta
        self.iteration = 0
        self.best_loss = float("inf")

    def _mean(self, x: torch.Tensor) -> torch.Tensor:
        return pmesh.data_mean(x, self.mesh)

    def _place_params(self) -> dict:
        """The placement policy (JAX's ``_place_params``): TP over the
        mesh's model axis when it has one, composed with FSDP over the data
        axis under ``train.fsdp``; replicated otherwise. Adam's moments take
        their master's placement."""
        return partitioning.shard_params(
            self.pipeline.core, self.mesh,
            fsdp_axis="data" if bool(self.cfg.get("fsdp", False)) else None,
            fsdp_min_size=self.cfg.get("fsdp_min_size", None))

    def init_state(self) -> None:
        """A fresh optimizer (and its train step) over the core's current
        parameters, placed on the mesh when there is one."""
        core = self.pipeline.core
        n_params = sum(p.numel() for p in core.parameters())
        if self.mesh is None:
            self.optimizer = make_mage_optimizer(core)
            self.train_step = make_mage_train_step(self.pipeline, self.optimizer,
                                                   self.compute_dtype)
        else:
            # dropout draws from torch's default generators: each data
            # coordinate seeds its own, and the ranks of one coordinate, which
            # run the same forward, draw the same masks
            torch.manual_seed(self.seed + 1000003 * pmesh.axis_index(self.mesh, "data"))
            self.masters = self._place_params()
            # the masters hold the parameters now: the core keeps empty
            # tensors in their place until sync_module writes them back
            for p in core.parameters():
                p.data = p.data.new_empty(0)
            self.optimizer = make_mage_optimizer(
                None, params=[m for m, _ in self.masters.values()])
            # the train step runs the model axis' split weights as shards
            # (tensor-parallel compute); evaluation runs them whole
            split = functools.partial(partitioning.gather, self.masters, self.mesh,
                                      local_model=True)
            gathered = functools.partial(partitioning.gather, self.masters, self.mesh)
            step = make_mage_train_step(
                self.pipeline, self.optimizer, self.compute_dtype,
                loss=functools.partial(train_loss, mean=self._mean), params_fn=split)
            eval_step = make_mage_eval_step(self.pipeline, self.compute_dtype,
                                            params_fn=gathered)
            model_group = (self.mesh.get_group("model")
                           if pmesh.axis_size(self.mesh, "model") > 1 else None)

            def train_step(*args, **kwargs):
                with tensor_parallel.model_axis(model_group):
                    terms = step(*args, **kwargs)
                return {k: v if k in ("beta", "_pid_state") else self._mean(v)
                        for k, v in terms.items()}

            def eval_step_mean(*args, **kwargs):
                return {k: self._mean(v) for k, v in eval_step(*args, **kwargs).items()}

            self.train_step, self.eval_step = train_step, eval_step_mean
        if pmesh.is_main_rank(self.mesh):
            print(f"stage-2 params: {n_params:,}")

    def state_dict(self) -> dict:
        """The core's whole state dict; with a mesh, its parameters gathered
        from the masters (a collective: every rank calls it)."""
        sd = self.pipeline.core.state_dict()
        if self.masters is not None:
            with torch.no_grad():
                sd.update(partitioning.gather(self.masters, self.mesh))
        return sd

    def _optimizer_state(self) -> dict:
        """The optimizer's state dict, each moment of a master gathered whole
        into the port's layout (every rank calls it)."""
        state = self.optimizer.state_dict()
        if self.masters is not None:
            from torch.distributed.tensor import DTensor

            layouts = [layout for _, layout in self.masters.values()]
            state["state"] = {
                i: {k: layouts[i].from_view(v.full_tensor()) if isinstance(v, DTensor) else v
                    for k, v in st.items()}
                for i, st in state["state"].items()}
        return state

    def _state(self) -> dict:
        """What a checkpoint holds: the step, the core and the optimizer."""
        return {"step": self.iteration, "model": self.state_dict(),
                "optimizer": self._optimizer_state()}

    def resume(self, name_or_path: str) -> None:
        """Restore a checkpoint of :meth:`state` and the host sidecar (onto
        the live placement, with a mesh)."""
        if self.optimizer is None:
            raise RuntimeError("resume after init_state: it restores into the optimizer")
        restored = self.ckpt.restore(name_or_path, map_location=self.pipeline.device)
        core = self.pipeline.core
        optim = restored["optimizer"]
        if self.masters is None:
            core.load_state_dict(restored["model"])
        else:
            if set(restored["model"]) != set(core.state_dict()):
                raise KeyError(f"checkpoint keys differ from the core's: "
                               f"{sorted(set(restored['model']) ^ set(core.state_dict()))}")
            entries = list(self.masters.values())
            with torch.no_grad():
                for name, buf in core.named_buffers():
                    buf.copy_(restored["model"][name])
                for name, (master, layout) in self.masters.items():
                    master.copy_(partitioning.distribute_like(master, restored["model"][name],
                                                              layout))
            optim["state"] = {
                i: {k: partitioning.distribute_like(entries[i][0], v, entries[i][1])
                    if k != "step" else v for k, v in st.items()}
                for i, st in optim["state"].items()}
        self.optimizer.load_state_dict(optim)
        self.iteration = int(restored["step"])
        sidecar = self.ckpt.path(HOST_STATE)
        if os.path.exists(sidecar):
            with open(sidecar) as fp:
                host = json.load(fp)
            self.best_loss = host.get("best_loss", self.best_loss)
            self.beta = host.get("beta", self.beta)
            if self.pid_state is not None and "pid" in host:
                pid = host["pid"]
                self.pid_state = torch.tensor([pid["i_k1"], pid["w_k1"], pid["e_k1"]],
                                              dtype=torch.float32, device=self.pipeline.device)

    def sync_module(self) -> None:
        """Give the core's own parameters the masters' values (for
        generation or export after training on a mesh; a collective; the
        end of ``fit`` calls it)."""
        if self.masters is not None:
            with torch.no_grad():
                for name, value in partitioning.gather(self.masters, self.mesh).items():
                    self.pipeline.core.get_parameter(name).data = value.contiguous()

    def _save_host_state(self) -> None:
        host = {"iteration": self.iteration, "best_loss": self.best_loss, "beta": self.beta}
        if self.pid_state is not None:
            i_k1, w_k1, e_k1 = self.pid_state.tolist()
            host["pid"] = {"i_k1": i_k1, "w_k1": w_k1, "e_k1": e_k1}
        with open(self.ckpt.path(HOST_STATE), "w") as fp:
            json.dump(host, fp)

    @staticmethod
    def _prep(batch: Mapping[str, Any]) -> dict:
        return {k: v for k, v in batch.items() if k != "video_id"}

    def fit(self, train_loader, test_loader, start_epoch: int = 0) -> None:
        """Epochs ``start_epoch`` .. ``train.epoch`` - 1 over ``train_loader``
        (an iterable of batches; its ``set_epoch`` is called when it has
        one), validating and checkpointing every ``checkpoint_every``
        iterations on ``test_loader``."""
        cfg = self.cfg
        epochs = int(cfg.get("epoch", 1))
        checkpoint_every = int(cfg.get("checkpoint_every", 500))
        if self.optimizer is None:
            self.init_state()
        timer = Timer(start_from=self.iteration + 1)
        # each data coordinate draws its own posterior noise
        generator = torch.Generator(device=self.pipeline.device).manual_seed(
            self.seed + 1000003 * pmesh.axis_index(self.mesh, "data"))
        for epoch in range(start_epoch, epochs):
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            lr = epoch_lr(
                float(cfg.get("lr", 5e-5)),
                epoch,
                epochs,
                cos=bool(cfg.get("cos", True)),
                lr_steps=cfg.get("lr_steps", []),
                lr_gamma=float(cfg.get("lr_gamma", 0.1)),
            )
            self.writer.add_scalar("learning_rate", lr, self.iteration)
            for batch in train_loader:
                timer.tic()
                terms = self.train_step(
                    self._prep(batch), lr,
                    self.pid_state if self.pid_state is not None else self.beta,
                    self.pipeline.alpha, generator=generator)
                self.iteration += 1
                if self.pid_state is not None:
                    self.pid_state = terms.pop("_pid_state")
                host_terms = {k: float(v) for k, v in terms.items()}
                timer.toc()
                if self.pid_state is not None:
                    self.beta = host_terms["beta"]
                self.writer.add_scalars("loss/train/", host_terms, self.iteration)
                if self.iteration % 50 == 0 and pmesh.is_main_rank(self.mesh):
                    print(f"iter {self.iteration} (epoch {epoch}), "
                          f"train_loss = {host_terms['final_loss']:.6f} | {timer.stats}")
                if self.iteration % checkpoint_every == 0:
                    self.validate_and_checkpoint(test_loader, epoch)
        self.sync_module()

    def validate_and_checkpoint(self, test_loader, epoch: int) -> float:
        """Mean eval terms over ``test_loader`` (over every rank's shard with
        a mesh); saves ``iteration_N``, and ``model_best`` when the mean
        final loss is the best so far (rank 0 writes)."""
        totals, count = {}, 0
        generator = torch.Generator(device=self.pipeline.device).manual_seed(self.seed + 1)
        for batch in test_loader:
            terms = self.eval_step(self._prep(batch), self.beta, self.pipeline.alpha,
                                   generator=generator)
            for k, v in terms.items():
                totals[k] = totals.get(k, 0.0) + float(v)
            count += 1
        mean = {k: v / max(count, 1) for k, v in totals.items()}
        test_loss = mean.get("final_loss", float("nan"))
        state = self._state()
        if pmesh.is_main_rank(self.mesh):
            print(f"iteration {self.iteration} (epoch {epoch}), test_loss = {test_loss:.6f}")
            self.writer.add_scalars("loss/val/", mean, self.iteration)
            self.ckpt.save(f"iteration_{self.iteration}", state)
        if test_loss < self.best_loss:
            self.best_loss = test_loss
            if pmesh.is_main_rank(self.mesh):
                self.ckpt.save("model_best", state)
        if pmesh.is_main_rank(self.mesh):
            self._save_host_state()
        return test_loss
