"""YAML-backed configuration with attribute access.

Mirrors the reference's YAML -> EasyDict surface (reference:
``main_ae.py:196-218``) without depending on easydict: nested dicts become
:class:`Config` objects supporting both ``cfg.train.lr`` and
``cfg['train']['lr']``, plus ``.get(key, default)``.

Also implements the reference's per-scene sweep semantics: a dict-valued
``dataset.split_file`` fans out into one config per scene
(reference: ``main_ae.py:202-212``).

The port's own copy of ``rald_tpu/config.py`` (YAML only), so that
``rald_torch`` reads the same config files without importing ``rald_tpu``.
"""
from __future__ import annotations

import copy
import os
from pathlib import Path
from typing import Any, Iterator

import yaml


class Config(dict):
    """A dict with attribute access, recursively applied."""

    def __init__(self, data: dict | None = None, **kwargs):
        super().__init__()
        data = dict(data or {})
        data.update(kwargs)
        for k, v in data.items():
            self[k] = _wrap(v)

    def __setitem__(self, key, value):
        super().__setitem__(key, _wrap(value))

    def __setattr__(self, key, value):
        self[key] = value

    def __getattr__(self, key) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __delattr__(self, key):
        try:
            del self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __deepcopy__(self, memo):
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_dict(self) -> dict:
        return {k: (v.to_dict() if isinstance(v, Config) else v) for k, v in self.items()}


def _wrap(value):
    if isinstance(value, Config):
        return value
    if isinstance(value, dict):
        return Config(value)
    if isinstance(value, (list, tuple)):
        return type(value)(_wrap(v) for v in value)
    return value


def load_config(path: str | os.PathLike) -> Config:
    """Load a YAML config file into a :class:`Config`."""
    with open(path, "r") as f:
        return Config(yaml.safe_load(f))


def dump_config(cfg: Config, path: str | os.PathLike) -> None:
    """Snapshot a config into the output dir (reference: main_ae.py:210-217)."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(cfg.to_dict(), f, sort_keys=False)


def expand_experiment_sweep(cfg: Config) -> Iterator[tuple[str | None, Config]]:
    """Yield (scene_name, config) pairs.

    If ``cfg.dataset.split_file`` is a dict mapping scene -> split file, the
    experiment fans out into one run per scene, with the scene name appended
    to output/log dirs — matching the reference sweep (main_ae.py:202-212).
    Otherwise yields a single ``(None, cfg)``.
    """
    split = cfg.get("dataset", Config()).get("split_file")
    if isinstance(split, dict):
        for scene, split_file in split.items():
            sub = copy.deepcopy(cfg)
            sub.dataset.split_file = split_file
            if sub.get("system", Config()).get("output_dir"):
                sub.system.output_dir = os.path.join(sub.system.output_dir, scene)
            if sub.get("system", Config()).get("log_dir"):
                sub.system.log_dir = os.path.join(sub.system.log_dir, scene)
            yield scene, sub
    else:
        yield None, cfg


def finalize_dirs(cfg: Config) -> Config:
    """Join expname into output/log dirs (reference: main_ae.py:200-201)."""
    if "system" in cfg:
        exp = cfg.system.get("expname", "")
        if cfg.system.get("output_dir"):
            cfg.system.output_dir = os.path.join(cfg.system.output_dir, exp)
        if cfg.system.get("log_dir"):
            cfg.system.log_dir = os.path.join(cfg.system.log_dir, exp)
    return cfg
