"""YAML configs with ``{target, params}`` instantiation, for the port.

The port's own copy of ``mage_tpu/config.py``: the same ``Config`` dict, the
same ordered deep merge and the same YAML files. Targets naming a
``mage_tpu.`` module, or one of the reference repo's class paths, resolve to
the matching class in ``mage_tpu_torch``, so the shipped configs build the
port unchanged; any other dotted path names a user's own class.
"""

from __future__ import annotations

import copy
import importlib
import os
from typing import Any, Mapping, Optional

import yaml


class Config(dict):
    """A dict with attribute access, recursive wrapping, and deep merge."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for k, v in list(self.items()):
            super().__setitem__(k, _wrap(v))

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = _wrap(value)

    def __setitem__(self, name: str, value: Any) -> None:
        super().__setitem__(name, _wrap(value))


def _wrap(value: Any) -> Any:
    if isinstance(value, Config):
        return value
    if isinstance(value, Mapping):
        return Config(value)
    if isinstance(value, (list, tuple)):
        return [_wrap(v) for v in value]
    return value


def _unwrap(value: Any) -> Any:
    if isinstance(value, Mapping):
        return {k: _unwrap(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_unwrap(v) for v in value]
    return value


def merge_configs(base: Optional[Mapping], override: Optional[Mapping]) -> Config:
    """Deep merge with deterministic precedence: ``override`` wins."""
    out = Config(copy.deepcopy(_unwrap(base)) if base else {})
    for k, v in (override or {}).items():
        if k in out and isinstance(out[k], Mapping) and isinstance(v, Mapping):
            out[k] = merge_configs(out[k], v)
        else:
            out[k] = copy.deepcopy(_unwrap(v)) if isinstance(v, Mapping) else v
    return out


def load_config(path: str | os.PathLike) -> Config:
    with open(path, "r") as fp:
        return Config(yaml.safe_load(fp) or {})


def loads_config(text: str) -> Config:
    return Config(yaml.safe_load(text) or {})


def save_config(cfg: Mapping, path: str | os.PathLike) -> None:
    """Write ``cfg`` as YAML in its key order (the trainer's config
    snapshot), creating the directory."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fp:
        yaml.safe_dump(_unwrap(cfg), fp, sort_keys=False)


# Reference-repo class paths -> the port's classes (the reference's YAML
# configs name torch classes, e.g. config/mage_caterv1.yaml:10,24,37,44).
REFERENCE_TARGET_ALIASES = {
    "modules.vqvae_model.VectorQuantizedVAE": "mage_tpu_torch.models.vqvae.VectorQuantizedVAE",
    "modules.mage_model.MAGE": "mage_tpu_torch.models.pipeline.MagePipeline",
    "modules.mage_model.TransformerTextEncoder": "mage_tpu_torch.models.layers.TransformerTextEncoder",
    "modules.mage_model.BertTextualHead": "mage_tpu_torch.models.text_heads.BertTextualHead",
    "modules.mage_model.MAEncoder": "mage_tpu_torch.models.layers.MAEncoder",
    "modules.mage_model.FlatAxialDecoder": "mage_tpu_torch.models.mage.FlatAxialDecoder",
    "ldm.models.autoencoder.AutoencoderKL": "mage_tpu_torch.models.autoencoder_kl.AutoencoderKL",
}
_JAX_PREFIX = "mage_tpu."


def target_path(string: str) -> str:
    """The port's dotted path for a config ``target`` string."""
    string = REFERENCE_TARGET_ALIASES.get(string, string)
    if string.startswith(_JAX_PREFIX):
        string = "mage_tpu_torch." + string[len(_JAX_PREFIX):]
    return string


def get_obj_from_str(string: str):
    """Resolve ``"module.sub.Class"`` (alias-mapped to the port) to the object."""
    module, cls = target_path(string).rsplit(".", 1)
    return getattr(importlib.import_module(module), cls)


def resolve_target(config: Optional[Mapping], default=None):
    """The class named by ``config['target']``, or ``default`` when the
    config names none. Reference class paths and ``mage_tpu.*`` paths give
    the port's classes (:func:`target_path`); any other dotted path is
    imported as it stands, so a user's own ``nn.Module`` can be named."""
    if isinstance(config, Mapping) and config.get("target"):
        return get_obj_from_str(str(config["target"]))
    return default


def instantiate_from_config(config: Mapping, merge: Optional[Mapping] = None):
    """Build ``target(**params)``; ``merge`` overrides params deterministically."""
    if not isinstance(config, Mapping) or "target" not in config:
        raise KeyError("Expected key `target` to instantiate.")
    params = merge_configs(config.get("params", {}), merge or {})
    return get_obj_from_str(config["target"])(**params)
