"""mage_tpu_torch: MAGE text-and-image-to-video generation in PyTorch and CUDA.

The port of ``mage_tpu`` (JAX) to one NVIDIA H100. It keeps the JAX
package's public layouts (NHWC frames, (B, T, h, w) ids, flat (L, N, D) KV
caches) and the reference PyTorch state-dict keys, and replaces each Pallas
kernel on its path with a kernel written by hand for Hopper (``csrc/``,
built at first use by ``_build``). It imports no JAX and nothing of
``mage_tpu``.

It covers generation for both models: discrete MAGE (the f8 VQ-VAE first
stage) and MAGE+ (the KL-autoencoder first stage with continuous latents and
the causal-GroupNorm head), the text and motion-anchor encoders, and the
axial decoder with the naive and the KV-cached sampler; stage-2 training
of both (``training/``: the teacher-forced loss, the bf16 mixed-precision
Adam step with in-step PID auto-beta, checkpoints and the trainer loop);
and stage-1 training of both first stages (the f4 and f8 VQ-VAE through
the straight-through quantizer, and the KL autoencoder).
"""

__version__ = "0.1.0"
