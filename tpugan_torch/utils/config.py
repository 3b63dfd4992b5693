"""Config dataclasses and flags: ``tpugan.utils.config`` (JAX-free), with a
``config_from_args`` that only parses. The JAX package's version also wires
``--dtype``, ``--debug_numerics`` and ``--ragged_last_batch`` into JAX-side
modules, which would import JAX; the port refuses those flags instead
(``tpugan_torch.train.loop.reject_unported_flags``).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from tpugan.utils.config import BaseConfig, add_config_args, flag

__all__ = ["BaseConfig", "config_from_args", "flag"]


def config_from_args(cls: type, argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(prog=getattr(cls, "prog", cls.__name__))
    add_config_args(parser, cls)
    return cls(**vars(parser.parse_args(argv)))
