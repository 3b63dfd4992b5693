"""Trainer registry of the port: ``cyclegan``, ``munit`` and ``wgan_gp``, so
far. Each trainer module exposes ``Config``, ``build``, ``create_state``, its
step makers (``make_step`` or ``make_steps``), ``make_loader``, ``run`` and
``main``."""

from __future__ import annotations

import importlib

_REGISTRY = {
    "cyclegan": "tpugan_torch.models.cyclegan",
    "munit": "tpugan_torch.models.munit",
    "wgan_gp": "tpugan_torch.models.wgan_gp",
}


class registry:
    @staticmethod
    def names():
        return sorted(_REGISTRY)

    @staticmethod
    def get(name: str):
        if name not in _REGISTRY:
            raise KeyError(f"unknown model {name!r}; ported: {', '.join(sorted(_REGISTRY))}")
        return importlib.import_module(_REGISTRY[name])
