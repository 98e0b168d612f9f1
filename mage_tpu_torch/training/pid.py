"""PI controller producing the KL weight beta (MAGE+ auto-beta).

The port's copy of ``mage_tpu/training/pid.py``: P term
``Kp / (1 + exp(err))``, integral accumulation, output clamped to [0, 1].
``anti_windup`` (default on) freezes the integral only when an update would
push further into saturation (w_k1 <= 0 with a negative delta, or w_k1 >= 1
with a positive one); ``anti_windup=False`` is the reference controller,
whose guard never fires.

- ``pid_update``: on a (3,) f32 tensor [i_k1, w_k1, e_k1], on the tensor's
  device, so the train step computes beta_t from step t's KL and weights
  step t's loss with it without a host round trip.
- ``PIDControl``: the host-side float twin.
"""

from __future__ import annotations

import math

import torch


def initial_pid_state(device=None) -> torch.Tensor:
    """Controller state [i_k1, w_k1, e_k1], all zero at t=0."""
    return torch.zeros(3, dtype=torch.float32, device=device)


def pid_update(
    pid_state: torch.Tensor,
    exp_kl: float,
    kl_loss: torch.Tensor,
    kp: float = 0.01,
    ki: float = -0.0001,
    anti_windup: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One controller step -> (beta in [0, 1], new [i_k1, w_k1, e_k1]),
    both f32 tensors on ``pid_state``'s device."""
    i_k1, w_k1 = pid_state[0], pid_state[1]
    err = exp_kl - torch.as_tensor(kl_loss, dtype=torch.float32, device=pid_state.device)
    # Kp / (1 + exp(err)); the reference guards err > 60 against overflow
    pk = kp * torch.where(err > 60.0, 0.0, 1.0 / (1.0 + torch.exp(torch.clamp(err, max=60.0))))
    delta = ki * err
    if anti_windup:
        freeze = ((w_k1 <= 0.0) & (delta < 0.0)) | ((w_k1 >= 1.0) & (delta > 0.0))
        ik = torch.where(freeze, i_k1, i_k1 + delta)
    else:
        ik = i_k1 + delta
    wk = pk + ik
    return torch.clamp(wk, 0.0, 1.0), torch.stack([ik, wk, err])


class PIDControl:
    def __init__(self, anti_windup: bool = True):
        self.i_k1 = 0.0
        self.w_k1 = 0.0
        self.e_k1 = 0.0
        self.anti_windup = anti_windup

    @staticmethod
    def _kp_fun(err: float, scale: float = 1.0) -> float:
        # guard against overflow for large positive error
        if err > 60:
            return 0.0
        return 1.0 / (1.0 + scale * math.exp(err))

    def pid(
        self,
        exp_kl: float,
        kl_loss: float,
        kp: float = 0.01,
        ki: float = -0.0001,
        kd: float = 0.0,
    ) -> tuple[float, float]:
        """-> (beta in [0, 1], error)."""
        error_k = exp_kl - kl_loss
        pk = kp * self._kp_fun(error_k)
        delta = ki * error_k
        ik = self.i_k1 + delta
        if self.anti_windup:
            # directional conditional integration (see pid_update)
            if (self.w_k1 <= 0 and delta < 0) or (self.w_k1 >= 1 and delta > 0):
                ik = self.i_k1
        elif self.w_k1 < 0 and self.w_k1 >= 1:  # the reference's guard, never true
            ik = self.i_k1
        wk = pk + ik
        self.w_k1 = wk
        self.i_k1 = ik
        self.e_k1 = error_k
        return min(max(wk, 0.0), 1.0), error_k
