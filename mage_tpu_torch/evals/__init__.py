"""Evaluation: video metrics, the I3D feature network and FVD."""

from mage_tpu_torch.evals.metrics import psnr
