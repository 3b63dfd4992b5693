"""Trainer registry of the port: ``cyclegan`` only, so far. Each trainer
module exposes ``Config``, ``build``, ``create_state``, ``make_step``,
``make_loader``, ``make_sampler``, ``run`` and ``main``."""

from __future__ import annotations

import importlib

_REGISTRY = {
    "cyclegan": "tpugan_torch.models.cyclegan",
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
