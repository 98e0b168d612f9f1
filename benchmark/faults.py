"""Faults planted in the program's timed path, to show that ``correct``
comes out false under each fault a cell can have: ``FAULTS[name](setattr,
discrete, codebook_size)`` patches the program's classes through
``setattr`` (pytest's ``monkeypatch.setattr``, or ``plant``'s own, which
``undo`` reverts). The CPU tests plant them at small sizes,
``benchmark.calibrate --fault`` on the card at a cell's own size."""

from __future__ import annotations

import torch

from benchmark import harness


def _alter(ids_or_latents, discrete, k):
    """One token of every frame altered: its id moved by K/2, or its latent by 1."""
    out = ids_or_latents.clone()
    if discrete:
        out[:, :, 0, 0] = (out[:, :, 0, 0] + k // 2) % k
    else:
        out[:, :, 0, 0] += 1.0
    return out


def token(setattr, discrete, k):
    """Generation: every generated frame of every clip gets one token altered."""
    from mage_tpu_torch.models.mage import MAGECore

    orig = MAGECore.generate_cached
    setattr(MAGECore, "generate_cached",
            lambda self, *a, **kw: _alter(orig(self, *a, **kw), discrete, k))


def half_batch(setattr, discrete, k):
    """Generation: only the first half of the batch is generated; the rest copies it."""
    from mage_tpu_torch.models.mage import MAGECore

    orig = MAGECore.generate_cached

    def half(self, latents0, text, speed=None, video_noise=None, **kw):
        h = latents0.shape[0] // 2
        out = orig(self, latents0[:h], text[:h], None if speed is None else speed[:h],
                   video_noise=None if video_noise is None else video_noise[:h], **kw)
        return torch.cat([out, out], dim=0)[:latents0.shape[0]]

    setattr(MAGECore, "generate_cached", half)


def frames(setattr, discrete, k):
    """Generation: the decoded frames of the first clip come out shifted."""
    from mage_tpu_torch.models import pipeline

    cls = pipeline.FirstStageVQVAE if discrete else pipeline.FirstStageKL
    orig = cls.decode

    def shifted(self, latents, *a, **kw):
        out = orig(self, latents, *a, **kw).clone()
        out[0] += 0.5
        return out

    setattr(cls, "decode", shifted)


def encode(setattr, discrete, k):
    """Generation and training: the first stage's latents (the first
    frame's, or every frame's ids in a train step) come out with one token
    of every frame altered."""
    from mage_tpu_torch.models.pipeline import MagePipeline

    orig = MagePipeline.encode_first_stage
    setattr(MagePipeline, "encode_first_stage",
            lambda self, *a, **kw: _alter(orig(self, *a, **kw), discrete, k))


def unchanged(setattr, discrete, k):
    """Training: the optimizer's step leaves the parameters and its state as they were."""
    setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def half_batch_train(setattr, discrete, k):
    """Training: the forward runs over the whole batch, but the step's
    prediction loss is the mean over its first half, the rest left out."""
    import torch.nn.functional as F
    from mage_tpu_torch.models.mage import MAGECore

    orig = MAGECore.forward

    def half(self, latents, *a, **kw):
        out = orig(self, latents, *a, **kw)
        h, pred = latents.shape[0] // 2, out["predict"][:latents.shape[0] // 2]
        target = latents[:h, 1:self.frames_length]
        if discrete:
            out["prediction"] = F.cross_entropy(pred.reshape(-1, pred.shape[-1]).float(),
                                                target.long().reshape(-1))
        else:
            out["prediction"] = ((pred.float() - target.float()) ** 2).mean()
        return out

    setattr(MAGECore, "forward", half)


FAULTS = {f.__name__: f for f in (token, half_batch, frames, encode, unchanged,
                                  half_batch_train)}
# the faults each traffic driver's cells can have
BY_DRIVER = {"generate": ("token", "half_batch", "frames", "encode"),
             "train": ("unchanged", "half_batch_train", "encode")}


def plant(name: str, cell: dict, config_path=None):
    """Plant fault ``name`` for ``cell``'s configuration -> a function that
    takes it out again."""
    path = config_path or harness.HERE / "configs" / f"{cell['config']}.json"
    p = harness.read_json(path)["model"]["params"]
    saved = []

    def set_(obj, attr, value):
        saved.append((obj, attr, vars(obj)[attr]))
        setattr(obj, attr, value)

    FAULTS[name](set_, bool(p["use_cids"]), int(p["codebook_size"]))

    def undo():
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)

    return undo
