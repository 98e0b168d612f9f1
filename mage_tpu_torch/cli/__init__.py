"""The port's command-line entry points, each runnable as
``python -m mage_tpu_torch.cli.<name>``: ``train_vqvae`` and
``train_autoencoder_kl`` (stage 1), ``main_mage`` (stage-2 training and
sampling), the end-to-end chains ``train_{mnist,mnist2,mnist_kl,cater,
cater_kl}_e2e``, and the evaluation path: ``train_fvd_extractor``,
``eval_fvd_e2e``, ``eval_speed_control``, ``eval_speed_control_cater`` and
``eval_precision``, the caption probes ``probe_text_sensitivity`` and
``probe_direction_binding{,2}``, and the run diagnostics ``diag_ar_drift``,
``diag_recon_bound``, ``diag_magep_semantic``, ``diag_magep_drift`` and
``eval_mnist2_ceiling``. Each takes ``--device`` (default ``cuda``) and calls
``main(argv)``, so a caller can drive it in process."""
