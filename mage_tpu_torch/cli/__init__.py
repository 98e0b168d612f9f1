"""The port's command-line entry points, each runnable as
``python -m mage_tpu_torch.cli.<name>``: ``train_vqvae`` and
``train_autoencoder_kl`` (stage 1) and ``main_mage`` (stage-2 training and
sampling). Each takes ``--device`` (default ``cuda``) and calls ``main(argv)``,
so a caller can drive it in process."""
