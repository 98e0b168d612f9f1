"""Stage-1 VQ-VAE trainer: the train, eval, reconstruction and codebook-restart
steps and the epoch loop, on one device.

Port of ``mage_tpu/training/vqvae_trainer.py``:

- Adam at a settable learning rate (torch's defaults are optax's: betas
  (0.9, 0.999), eps 1e-8).
- The reference's 3-term loss: MSE reconstruction + MSE(z_q_bar, sg z_e) +
  beta * MSE(z_e, sg z_q_bar), beta 2.0 by default.
- The train step updates BatchNorm's running averages. The eval step, the
  reconstruction and the restart run train-mode BatchNorm (batch statistics:
  the reference's validation never calls ``eval()``) and leave the running
  averages as they are, as the JAX steps drop the mutated ``batch_stats``.
- The opt-in dead-code restart: one train-mode forward, the ids of its
  ``z_e`` from the ids-only vq launch, and every code no token chose re-seeded
  to a random encoder output plus 0.01 x standard-normal noise. Adam's
  moments are left as they are.
- Per epoch: validation, a ``best`` (lowest test reconstruction) and a
  ``model_{epoch}`` checkpoint (``{"step", "state_dict", "optimizer"}``,
  which ``FirstStageVQVAE.from_config`` loads as ``ckpt_path``), and image
  grids of fixed images and their reconstructions.

Batches are NHWC frames, numpy arrays or tensors. With a ``mesh``
(``parallel.make_mesh``, one process per device, each fed its slice of the
global batch) the trainer is data parallel as the JAX trainer's mesh is:
the parameters are replicated and their gradients averaged over the
``data`` axis (torch's ``DistributedDataParallel``), train-mode BatchNorm
takes its statistics over the global batch, the restart picks from every
rank's tokens, the reported losses are the global batch's, and only rank 0
writes logs and checkpoints.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from mage_tpu_torch.models.pipeline import init_weights, resolve_device
from mage_tpu_torch.models.vqvae import BatchNorm2d, VectorQuantizedVAE, batch_statistics_only
from mage_tpu_torch.ops.vq import nearest_codebook_indices
from mage_tpu_torch.parallel import mesh as pmesh
from mage_tpu_torch.training.checkpoint import Checkpointer
from mage_tpu_torch.utils import MetricsWriter, Timer
from mage_tpu_torch.utils.metrics import NullWriter


def make_optimizer(model: torch.nn.Module, lr: float = 1e-4) -> torch.optim.Adam:
    """Adam over every parameter of ``model``; the train step sets its rate."""
    return torch.optim.Adam(model.parameters(), lr=lr)


def loss_terms(model: VectorQuantizedVAE, images: torch.Tensor, beta: float):
    """-> (total loss, {reconstruction, quantization, commitment, total})
    of the model's forward in its current mode."""
    x_tilde, z_e, z_q_bar = model(images)
    recon = F.mse_loss(x_tilde, images)
    quant = F.mse_loss(z_q_bar, z_e.detach())
    commit = F.mse_loss(z_e, z_q_bar.detach())
    total = recon + quant + beta * commit
    return total, {"reconstruction": recon, "quantization": quant, "commitment": commit,
                   "total": total}


def make_train_step(model: VectorQuantizedVAE, optimizer: torch.optim.Optimizer,
                    beta: float = 2.0, mesh=None):
    """-> ``train_step(images, lr)``: one Adam update in train mode, the
    running averages moved; returns the detached loss terms. With a
    ``mesh`` the gradients (through torch's ``DistributedDataParallel``)
    and the terms are averaged over its ``data`` axis."""
    forward = model
    if pmesh.axis_size(mesh, "data") > 1:
        from torch.nn.parallel import DistributedDataParallel

        device = next(model.parameters()).device
        # the running averages come from the global batch on every rank
        # already: nothing to broadcast
        forward = DistributedDataParallel(
            model, device_ids=[device] if device.type == "cuda" else None,
            process_group=mesh.get_group("data"), broadcast_buffers=False)

    def train_step(images: torch.Tensor, lr: float) -> dict:
        for group in optimizer.param_groups:
            group["lr"] = lr
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss, aux = loss_terms(forward, images, beta)
        loss.backward()
        optimizer.step()
        return {k: pmesh.data_mean(v.detach(), mesh) for k, v in aux.items()}

    return train_step


def _forward_batch_statistics(model: VectorQuantizedVAE, images: torch.Tensor):
    model.train()
    with batch_statistics_only(model):
        return model(images)


def make_eval_step(model: VectorQuantizedVAE):
    """-> ``eval_step(images)``: {reconstruction, quantization} without
    gradients, BatchNorm on the batch statistics, running averages untouched."""

    @torch.no_grad()
    def eval_step(images: torch.Tensor) -> dict:
        x_tilde, z_e, z_q_bar = _forward_batch_statistics(model, images)
        return {"reconstruction": F.mse_loss(x_tilde, images),
                "quantization": F.mse_loss(z_q_bar, z_e)}

    return eval_step


def make_reconstruct(model: VectorQuantizedVAE):
    """-> ``reconstruct(images)``: ``x_tilde`` as the eval step computes it."""

    @torch.no_grad()
    def reconstruct(images: torch.Tensor) -> torch.Tensor:
        return _forward_batch_statistics(model, images)[0]

    return reconstruct


def make_restart_dead_codes(model: VectorQuantizedVAE, mesh=None):
    """-> ``restart(images, pick=None, noise=None, generator=None)``, which
    re-seeds every code that no token of ``images`` selects and returns their
    number. The ids come from one train-mode forward's ``z_e`` (not from an
    eval-mode encode, whose uncalibrated running averages can select other
    codes). Code ``k`` becomes token ``pick[k]``'s encoder output plus 0.01 x
    ``noise[k]``; ``pick`` (K,) token indices and ``noise`` (K, D) standard
    normal are drawn from ``generator`` when not given. With a ``mesh`` the
    tokens are every ``data`` rank's, in rank order (the global batch's)."""

    @torch.no_grad()
    def restart(images: torch.Tensor, pick: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        _, z_e, _ = _forward_batch_statistics(model, images)
        codebook = model.codebook.embedding.weight
        k, d = codebook.shape
        feats = pmesh.gather_batch(z_e.reshape(-1, d), mesh)
        ids = nearest_codebook_indices(feats, codebook)
        dead = torch.bincount(ids.long(), minlength=k) == 0
        draw_on = generator.device if generator is not None else codebook.device
        if pick is None:
            pick = torch.randint(0, feats.shape[0], (k,), generator=generator, device=draw_on)
        if noise is None:
            noise = torch.randn(k, d, generator=generator, device=draw_on, dtype=codebook.dtype)
        seeds = feats[pick.to(codebook.device).long()].to(codebook.dtype)
        seeds = seeds + 0.01 * noise.to(codebook.device, codebook.dtype)
        codebook.copy_(torch.where(dead[:, None], seeds, codebook))
        return dead.sum()

    return restart


class VQVAETrainer:
    """The epoch loop over ``model``: Adam at ``lr``, commitment weight
    ``beta``, metrics under ``log_dir``, checkpoints under ``ckpt_dir``, and,
    with ``codebook_restart``, a dead-code restart on each epoch's last batch."""

    def __init__(self, model: VectorQuantizedVAE, lr: float = 1e-4, beta: float = 2.0,
                 log_dir: str = "./logs/vqvae", ckpt_dir: str = "./models/vqvae",
                 seed: int = 0, codebook_restart: bool = False,
                 device: Optional[str | torch.device] = None, mesh=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.lr = lr
        self.beta = beta
        self.seed = seed
        self.mesh = mesh
        self.main = pmesh.is_main_rank(mesh)
        self.writer = MetricsWriter(log_dir) if self.main else NullWriter()
        self.ckpt = Checkpointer(ckpt_dir)
        if pmesh.axis_size(mesh, "data") > 1:
            group = mesh.get_group("data")
            for m in model.modules():
                if isinstance(m, BatchNorm2d):
                    m.process_group = group
        self.eval_step = make_eval_step(model)
        self.reconstruct = make_reconstruct(model)
        # opt-in dead-code revival (off = reference parity)
        self.restart_dead = (make_restart_dead_codes(model, mesh) if codebook_restart
                             else None)
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.train_step = None
        self.steps = 0

    def init_state(self) -> None:
        """Fresh weights at the JAX package's init scales from ``seed``,
        reset running averages, and a fresh Adam."""
        init_weights(self.model, torch.Generator().manual_seed(self.seed))
        for m in self.model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.reset_running_stats()
        self.optimizer = make_optimizer(self.model, self.lr)
        self.train_step = make_train_step(self.model, self.optimizer, self.beta, self.mesh)
        self.steps = 0

    def _state(self) -> dict:
        return {"step": self.steps, "state_dict": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def resume(self, name_or_path: str) -> None:
        """Restore a checkpoint of this trainer (after ``init_state``)."""
        if self.optimizer is None:
            raise RuntimeError("resume after init_state: it restores into the optimizer")
        restored = self.ckpt.restore(name_or_path, map_location=self.device)
        self.model.load_state_dict(restored["state_dict"])
        self.optimizer.load_state_dict(restored["optimizer"])
        self.steps = int(restored["step"])

    def _images(self, images) -> torch.Tensor:
        return torch.as_tensor(images).to(self.device, torch.float32)

    def fit(self, train_loader, test_loader, num_epochs: int,
            fixed_images: Optional[np.ndarray] = None, log_every: int = 50) -> float:
        """``num_epochs`` epochs over ``train_loader`` (its ``set_epoch`` is
        called when it has one), each followed by validation on
        ``test_loader`` and the checkpoints; returns the best test
        reconstruction."""
        if self.optimizer is None:
            self.init_state()
        best_loss = None
        timer = Timer(total_iterations=num_epochs)
        if fixed_images is not None:
            self.writer.add_image_grid("original", np.asarray(fixed_images), 0)
        for epoch in range(num_epochs):
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            timer.tic()
            for images in train_loader:
                images = self._images(images)
                aux = self.train_step(images, self.lr)
                self.steps += 1
                if self.steps % log_every == 0:
                    self.writer.add_scalars(
                        "loss/train/", {k: float(v) for k, v in aux.items()}, self.steps)
            if self.restart_dead is not None:
                # probe = the epoch's last batch
                gen = torch.Generator().manual_seed(self.seed * 100003 + epoch)
                n_dead = self.restart_dead(images, generator=gen)
                self.writer.add_scalar("codebook/restarted", int(n_dead), self.steps)
            timer.toc()

            losses = self.evaluate(test_loader)
            self.writer.add_scalars("loss/test/", losses, self.steps)
            if self.main:
                print(f"epoch {epoch}, test_recon = {losses['reconstruction']:.6f} "
                      f"| {timer.stats}")
            if fixed_images is not None:
                recon = self.reconstruct(self._images(fixed_images))
                self.writer.add_image_grid("reconstruction", recon.cpu().numpy(), epoch + 1)
            total = losses["reconstruction"]
            if best_loss is None or total < best_loss:
                best_loss = total
                if self.main:
                    self.ckpt.save("best", self._state())
            if self.main:
                self.ckpt.save(f"model_{epoch + 1}", self._state())
        return best_loss if best_loss is not None else float("nan")

    def evaluate(self, loader) -> dict:
        """Mean eval terms over ``loader``'s batches (and over the ``data``
        ranks' shards, with a mesh)."""
        totals: dict[str, float] = {}
        count = 0
        for images in loader:
            for k, v in self.eval_step(self._images(images)).items():
                totals[k] = totals.get(k, 0.0) + float(pmesh.data_mean(v, self.mesh))
            count += 1
        if count == 0:
            return {"reconstruction": float("nan"), "quantization": float("nan")}
        return {k: v / count for k, v in totals.items()}
