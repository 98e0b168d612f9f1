"""Stage-1 KL-autoencoder trainer (the MAGE+ first stage), on one device.

Port of the step and loop that ``train_autoencoder_kl.py`` inlines:

- the loss: MSE reconstruction + ``kl_weight`` (1e-6 by default) x the
  posterior's KL, summed over the latent and averaged over the batch (the
  LDM recipe without its adversarial and perceptual terms);
- Adam at 4.5e-6 (torch's defaults are optax's);
- the train step in train mode, where the decoder takes the plain
  GroupNorm-SiLU-conv chain and launches no kernel; the eval step in eval
  mode, where its ``ResnetBlock``s run the fused ``gn_silu_conv3x3`` op as
  the MAGE+ decode does;
- per epoch, a ``best`` (lowest test reconstruction) and a ``model_{epoch}``
  checkpoint (``{"step", "state_dict", "optimizer"}``, the ldm layout that
  ``FirstStageKL.from_config`` loads as ``ckpt_path``).

The posterior's noise is passed in, or drawn from a ``torch.Generator``:
the trainer's is seeded from ``seed`` for training and from 0 for each
validation, as the CLI keys its eval step with ``PRNGKey(0)``. Batches are
NHWC frames, numpy arrays or tensors. One device only (ROADMAP A12).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from mage_tpu_torch.models.autoencoder_kl import AutoencoderKL
from mage_tpu_torch.models.pipeline import init_weights, resolve_device
from mage_tpu_torch.training.checkpoint import Checkpointer
from mage_tpu_torch.utils import MetricsWriter, Timer


def make_optimizer(model: torch.nn.Module, lr: float = 4.5e-6) -> torch.optim.Adam:
    return torch.optim.Adam(model.parameters(), lr=lr)


def loss_terms(model: AutoencoderKL, images: torch.Tensor, kl_weight: float,
               noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
    """-> (loss, {reconstruction, kl}) of the model's forward in its current
    mode."""
    recon, posterior = model(images, noise, generator)
    rec = F.mse_loss(recon, images)
    kl = posterior.kl().mean()
    return rec + kl_weight * kl, {"reconstruction": rec, "kl": kl}


def make_train_step(model: AutoencoderKL, optimizer: torch.optim.Optimizer,
                    kl_weight: float = 1e-6):
    """-> ``train_step(images, noise=None, generator=None)``: one Adam update
    in train mode; returns the detached terms."""

    def train_step(images: torch.Tensor, noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> dict:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss, aux = loss_terms(model, images, kl_weight, noise, generator)
        loss.backward()
        optimizer.step()
        return {k: v.detach() for k, v in aux.items()}

    return train_step


def make_eval_step(model: AutoencoderKL):
    """-> ``eval_step(images, noise=None, generator=None)``: {reconstruction,
    kl} in eval mode without gradients."""

    @torch.no_grad()
    def eval_step(images: torch.Tensor, noise: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> dict:
        model.eval()
        recon, posterior = model(images, noise, generator)
        return {"reconstruction": F.mse_loss(recon, images), "kl": posterior.kl().mean()}

    return eval_step


class KLAETrainer:
    """The epoch loop of ``train_autoencoder_kl.py`` over ``model``."""

    def __init__(self, model: AutoencoderKL, lr: float = 4.5e-6, kl_weight: float = 1e-6,
                 log_dir: str = "./models/log/kl_f8_cater",
                 ckpt_dir: str = "./models/autoencoders/kl_f8_cater", seed: int = 0,
                 device: Optional[str | torch.device] = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.lr = lr
        self.kl_weight = kl_weight
        self.seed = seed
        self.writer = MetricsWriter(log_dir)
        self.ckpt = Checkpointer(ckpt_dir)
        self.eval_step = make_eval_step(model)
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.train_step = None
        self.steps = 0

    def init_state(self) -> None:
        """Fresh weights from ``seed`` (``init_weights``) and a fresh Adam."""
        init_weights(self.model, torch.Generator().manual_seed(self.seed))
        self.optimizer = make_optimizer(self.model, self.lr)
        self.train_step = make_train_step(self.model, self.optimizer, self.kl_weight)
        self.steps = 0
        n = sum(p.numel() for p in self.model.parameters())
        print(f"KL-AE params: {n:,}")

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

    def fit(self, train_loader, test_loader, num_epochs: int, log_every: int = 50) -> float:
        """``num_epochs`` epochs over ``train_loader``, each followed by
        validation on ``test_loader`` and the checkpoints; returns the best
        test reconstruction."""
        if self.optimizer is None:
            self.init_state()
        generator = torch.Generator(device=self.device).manual_seed(self.seed)
        best = None
        timer = Timer(total_iterations=num_epochs)
        for epoch in range(num_epochs):
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            timer.tic()
            for images in train_loader:
                aux = self.train_step(self._images(images), generator=generator)
                self.steps += 1
                if self.steps % log_every == 0:
                    self.writer.add_scalars(
                        "loss/train/", {k: float(v) for k, v in aux.items()}, self.steps)
            timer.toc()
            mean = self.evaluate(test_loader)
            self.writer.add_scalars("loss/test/", mean, self.steps)
            print(f"epoch {epoch}, test_recon = {mean['reconstruction']:.6f} | {timer.stats}")
            if best is None or mean["reconstruction"] < best:
                best = mean["reconstruction"]
                self.ckpt.save("best", self._state())
            self.ckpt.save(f"model_{epoch + 1}", self._state())
        return best if best is not None else float("nan")

    def evaluate(self, loader) -> dict:
        """Mean eval terms over ``loader``'s batches, the posterior noise
        drawn from a generator seeded with 0."""
        generator = torch.Generator(device=self.device).manual_seed(0)
        totals: dict[str, float] = {}
        count = 0
        for images in loader:
            for k, v in self.eval_step(self._images(images), generator=generator).items():
                totals[k] = totals.get(k, 0.0) + float(v)
            count += 1
        if count == 0:
            return {"reconstruction": float("nan"), "kl": float("nan")}
        return {k: v / count for k, v in totals.items()}
