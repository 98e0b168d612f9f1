"""Training: stage 1 (the VQ-VAE and KL-autoencoder trainers) and stage 2
(the learning-rate schedules, the auto-beta PID controller, checkpoints, and
the MAGE train step and trainer)."""
