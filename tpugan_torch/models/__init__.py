"""Registry of the port: all 33 entries of the JAX package's, the 32
trainers and ``test_on_image``. Each trainer module exposes ``Config``,
``build``, ``create_state``, its step makers (``make_step`` or
``make_steps``), ``make_loader``, ``run`` and ``main``; ``test_on_image``
exposes ``Config``, ``infer_image`` and ``main``."""

from __future__ import annotations

import importlib

_REGISTRY = {
    name: f"tpugan_torch.models.{name}"
    for name in ("aae", "acgan", "began", "bgan", "bicyclegan", "ccgan", "cgan", "cluster_gan",
                 "cogan", "context_encoder", "cyclegan", "dcgan", "discogan", "dragan", "dualgan",
                 "ebgan", "esrgan", "gan", "infogan", "lsgan", "munit", "pix2pix", "pixelda",
                 "relativistic_gan", "sgan", "softmax_gan", "srgan", "stargan", "test_on_image",
                 "unit", "wgan", "wgan_div", "wgan_gp")
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
