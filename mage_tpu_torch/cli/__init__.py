"""The port's command-line entry points, each runnable as
``python -m mage_tpu_torch.cli.<name>``: ``train_vqvae`` and
``train_autoencoder_kl`` (stage 1), ``main_mage`` (stage-2 training and
sampling), the end-to-end chains ``train_{mnist,mnist2,mnist_kl,cater,
cater_kl}_e2e``, and the evaluation path: ``train_fvd_extractor``,
``eval_fvd_e2e``, ``eval_speed_control``, ``eval_speed_control_cater`` and
``eval_precision``. Each takes ``--device`` (default ``cuda``) and calls
``main(argv)``, so a caller can drive it in process."""
