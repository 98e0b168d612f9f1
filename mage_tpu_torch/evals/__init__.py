"""Evaluation: video metrics, the I3D feature network, FVD and caption precision."""

from mage_tpu_torch.evals.metrics import psnr
