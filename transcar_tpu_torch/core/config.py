"""Configuration: the JAX package's presets, shared rather than forked.

``transcar_tpu/core/config.py`` imports only the standard library, but
importing it as ``transcar_tpu.core.config`` first runs
``transcar_tpu/core/__init__.py``, which imports ``jax.numpy``.  So the
file is loaded here by path, under a module name of this package, and its
public names are re-exported: the port reads the same presets and
``--cfg-options`` overrides as the JAX package, and never imports jax.
"""
from __future__ import annotations

import importlib.util
import pathlib
import sys

_REPO = pathlib.Path(__file__).resolve().parents[2]


def load_shared(relpath: str):
    """Load a jax-free source file of the JAX package by path.

    The module is registered as ``transcar_tpu_torch._shared.<stem>`` so
    that neither ``transcar_tpu`` nor ``jax`` enters ``sys.modules``.
    """
    name = "transcar_tpu_torch._shared." + pathlib.Path(relpath).stem
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, _REPO / relpath)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module      # dataclasses resolve their module here
    spec.loader.exec_module(module)
    return module


_config = load_shared("transcar_tpu/core/config.py")

PC_RANGE = _config.PC_RANGE
CLASS_NAMES = _config.CLASS_NAMES
BackboneConfig = _config.BackboneConfig
HeadConfig = _config.HeadConfig
ModelConfig = _config.ModelConfig
DataConfig = _config.DataConfig
OptimConfig = _config.OptimConfig
TrainConfig = _config.TrainConfig
TransCARConfig = _config.TransCARConfig
get_preset = _config.get_preset
list_presets = _config.list_presets
