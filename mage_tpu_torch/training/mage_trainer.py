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

Dropout draws from torch's default generator; the posterior and KL-AE noise
from the ``generator`` passed to a step. One device only: the JAX trainer's
mesh, tensor-parallel and FSDP placement wait for ROADMAP A12.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Mapping, Optional

import torch

from mage_tpu_torch.models.pipeline import MagePipeline
from mage_tpu_torch.training.checkpoint import Checkpointer
from mage_tpu_torch.training.lr import epoch_lr
from mage_tpu_torch.training.pid import initial_pid_state, pid_update
from mage_tpu_torch.utils import MetricsWriter, Timer

HOST_STATE = "trainer_state.json"


def make_mage_optimizer(core: torch.nn.Module, lr: float = 1e-4) -> torch.optim.Adam:
    """Adam over the core's parameters; the train step sets its rate."""
    return torch.optim.Adam(core.parameters(), lr=lr, betas=(0.9, 0.98), eps=1e-6)


def cast_floating(params: Mapping[str, torch.Tensor], dtype: torch.dtype) -> dict:
    """f32 tensors -> ``dtype`` copies (mixed-precision compute copies,
    through which gradients flow back to the f32 tensors); others pass."""
    return {k: v.to(dtype) if v.dtype == torch.float32 else v for k, v in params.items()}


def train_loss(pipeline: MagePipeline, terms: dict, beta, alpha) -> torch.Tensor:
    """The step's loss from the raw terms, with ``terms`` completed in place:
    ``prediction``, plus, on the stochastic branch, beta * KL and
    alpha * speed_l2 for a fixed ``beta``, or, under auto-beta, beta_t * KL
    with beta_t = PID(this step's KL) from the (3,) controller state
    ``beta``; ``terms`` then gains ``beta`` and ``_pid_state``."""
    final = terms["prediction"]
    if pipeline.randomness:
        if pipeline.auto_beta:
            beta_t, new_pid = pid_update(beta, pipeline.v_kl, terms["kl_loss"].detach())
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
                         loss: Callable = train_loss):
    """-> ``train_step(batch, lr, beta, alpha, generator=None,
    posterior_noise=None, first_stage_noise=None)``: one update of the
    core's parameters in place; returns the detached terms. ``beta`` is the
    fixed KL weight, or under auto-beta the (3,) PID state. After the call
    each parameter's ``grad`` holds this step's gradient. ``loss(pipeline,
    terms, beta, alpha)`` makes the step's loss from the raw terms
    (``train_loss``, or the e2e chains' own weighting)."""
    core = pipeline.core

    def train_step(batch: Mapping[str, Any], lr: float, beta, alpha: float,
                   generator: Optional[torch.Generator] = None,
                   posterior_noise=None, first_stage_noise=None) -> dict:
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.zero_grad(set_to_none=True)
        params = None
        if compute_dtype is not None:
            params = cast_floating(dict(core.named_parameters()), compute_dtype)
        terms = pipeline.loss_terms(
            batch, train=True, params=params, compute_dtype=compute_dtype,
            generator=generator, posterior_noise=posterior_noise,
            first_stage_noise=first_stage_noise)
        loss(pipeline, terms, beta, alpha).backward()
        optimizer.step()
        return {k: v.detach() for k, v in terms.items()}

    return train_step


def make_mage_eval_step(pipeline: MagePipeline, compute_dtype: Optional[torch.dtype] = None,
                        test_flag: bool = False):
    """-> ``eval_step(batch, beta, alpha, generator=None, posterior_noise=
    None, video_noise=None, first_stage_noise=None)``: the loss terms in eval
    mode without gradients, with ``final_loss`` = prediction + beta * KL
    (+ alpha * speed_l2 for a fixed beta); ``beta`` is a number here.
    ``test_flag`` samples the stochastic branch's prior instead of its
    posterior."""
    core = pipeline.core

    @torch.no_grad()
    def eval_step(batch: Mapping[str, Any], beta: float, alpha: float,
                  generator: Optional[torch.Generator] = None,
                  posterior_noise=None, video_noise=None, first_stage_noise=None) -> dict:
        params = None
        if compute_dtype is not None:
            params = cast_floating(dict(core.named_parameters()), compute_dtype)
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
    ``lr_gamma``, ``checkpoint_every``, ``bf16``); checkpoints, the metrics
    log and the sidecar go to ``checkpoint_path``."""

    def __init__(self, pipeline: MagePipeline, train_cfg: Mapping[str, Any],
                 checkpoint_path: str, seed: int = 0):
        self.pipeline = pipeline
        self.cfg = train_cfg
        # train.bf16: true -> the mixed-precision step
        self.compute_dtype = torch.bfloat16 if bool(train_cfg.get("bf16", False)) else None
        self.eval_step = make_mage_eval_step(pipeline, self.compute_dtype)
        self.ckpt = Checkpointer(checkpoint_path)
        self.writer = MetricsWriter(checkpoint_path)
        self.seed = seed
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.train_step = None
        # auto-beta: the PID runs in the step; the trainer carries its state
        # and mirrors the latest beta on the host for eval, logging and resume
        self.pid_state = initial_pid_state(pipeline.device) if pipeline.auto_beta else None
        self.beta = 0.0 if pipeline.auto_beta else pipeline.beta
        self.iteration = 0
        self.best_loss = float("inf")

    def init_state(self) -> None:
        """A fresh optimizer (and its train step) over the core's current
        parameters."""
        self.optimizer = make_mage_optimizer(self.pipeline.core)
        self.train_step = make_mage_train_step(self.pipeline, self.optimizer,
                                               self.compute_dtype)
        n = sum(p.numel() for p in self.pipeline.core.parameters())
        print(f"stage-2 params: {n:,}")

    def _state(self) -> dict:
        """What a checkpoint holds: the step, the core and the optimizer."""
        return {"step": self.iteration, "model": self.pipeline.core.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def resume(self, name_or_path: str) -> None:
        """Restore a checkpoint of :meth:`state` and the host sidecar."""
        if self.optimizer is None:
            raise RuntimeError("resume after init_state: it restores into the optimizer")
        restored = self.ckpt.restore(name_or_path, map_location=self.pipeline.device)
        self.pipeline.core.load_state_dict(restored["model"])
        self.optimizer.load_state_dict(restored["optimizer"])
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
        generator = torch.Generator(device=self.pipeline.device).manual_seed(self.seed)
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
                if self.iteration % 50 == 0:
                    print(f"iter {self.iteration} (epoch {epoch}), "
                          f"train_loss = {host_terms['final_loss']:.6f} | {timer.stats}")
                if self.iteration % checkpoint_every == 0:
                    self.validate_and_checkpoint(test_loader, epoch)

    def validate_and_checkpoint(self, test_loader, epoch: int) -> float:
        """Mean eval terms over ``test_loader``; saves ``iteration_N``, and
        ``model_best`` when the mean final loss is the best so far."""
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
        print(f"iteration {self.iteration} (epoch {epoch}), test_loss = {test_loss:.6f}")
        self.writer.add_scalars("loss/val/", mean, self.iteration)
        state = self._state()
        self.ckpt.save(f"iteration_{self.iteration}", state)
        if test_loss < self.best_loss:
            self.best_loss = test_loss
            self.ckpt.save("model_best", state)
        self._save_host_state()
        return test_loss
