"""Config dataclasses and flags: the port's own copy of
``tpugan/utils/config.py`` (``flag``, ``BaseConfig``, ``add_config_args``),
with a ``config_from_args`` that parses and wires ``--dtype`` into the
layers, as the JAX package's does. That version also wires
``--debug_numerics`` and ``--ragged_last_batch`` into JAX-side modules; the
port refuses those two flags instead
(``tpugan_torch.train.loop.reject_unported_flags``).

Each trainer declares a ``Config`` dataclass whose field names, types and
defaults match the reference script's flags; the argparse parser is generated
from it, so ``python -m tpugan_torch <model>`` takes the command line of
``python -m tpugan <model>``.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, List, Optional, Sequence, get_args, get_origin

__all__ = ["BaseConfig", "add_config_args", "config_from_args", "flag"]


def flag(default: Any, help: str = "", **kw: Any) -> dataclasses.Field:
    """Declare a config field that maps to an argparse flag."""
    metadata = {"help": help}
    metadata.update(kw)
    if isinstance(default, (list, dict)):
        return dataclasses.field(
            default_factory=lambda: default, metadata=metadata
        )
    return dataclasses.field(default=default, metadata=metadata)


@dataclasses.dataclass
class BaseConfig:
    """Fields shared by every recipe but not part of the reference CLI.

    These are additive (the reference has no equivalents): they control the
    TPU-side execution without changing training semantics.
    """

    # Where datasets live (reference hardcodes ../../data relative to CWD).
    data_dir: str = flag("data", "root directory for datasets")
    # Output directories (reference writes images/ and saved_models/ in CWD).
    output_dir: str = flag(".", "root for images/ and saved_models/")
    # Deterministic seeding (reference is unseeded).
    seed: int = flag(0, "PRNG seed")
    # Print every N batches (reference prints every batch; 1 == parity).
    log_interval: int = flag(1, "batches between stdout loss lines")
    # Cap batches per epoch (for smoke tests / benchmarking; -1 = full epoch).
    max_batches: int = flag(-1, "limit batches per epoch (-1 = no limit)")
    # Use synthetic data when the real dataset is absent on disk.
    synthetic_data: bool = flag(False, "force synthetic procedural data")
    # Compute dtype for the model ("float32" parity default, "bfloat16" perf).
    dtype: str = flag("float32", "compute dtype: float32|bfloat16")
    # Machine-readable per-step metrics (jsonl lines of the step's scalar
    # outputs); "" disables. The reference only prints (SURVEY.md §5).
    metrics_jsonl: str = flag("", "path for per-step scalar metrics jsonl")
    # Capture a jax.profiler trace of steps [2, 2+N) into this directory;
    # "" disables.
    profile_dir: str = flag("", "jax.profiler trace output directory")
    profile_steps: int = flag(5, "number of steps to profile")
    # Debug mode: disable input prefetch + enable NaN checks (SURVEY.md §5
    # race-surface notes).
    debug_numerics: bool = flag(
        False, "synchronous input pipeline + jax_debug_nans"
    )
    # Live profiling: serve jax.profiler on this port for TensorBoard's
    # capture-profile UI (0 = off). Complements --profile_dir's
    # fixed-window trace (SURVEY.md §5 tracing hook).
    profile_port: int = flag(0, "jax.profiler server port (0 = off)")
    # Reference epoch semantics: run the ragged len(ds) % batch_size tail
    # batch each epoch (gan/gan.py:122-125) instead of dropping it. Costs
    # one extra XLA compile for the tail shape (data/loader.py docstring);
    # ignored under data parallelism (the tail cannot shard).
    ragged_last_batch: bool = flag(
        False, "train the reference's ragged final batch each epoch"
    )
    # Fuse K optimizer steps into one device dispatch via lax.scan
    # (train/loop.py:scan_steps). Numerics identical to K single dispatches;
    # amortizes host->device dispatch latency for millisecond-class steps.
    # Mid-chunk sample grids use the chunk's last step (pick a value
    # dividing --sample_interval for exact filename/image alignment).
    steps_per_dispatch: int = flag(1, "train steps fused per device dispatch")


def _field_type(f: dataclasses.Field) -> Any:
    t = f.type
    if isinstance(t, str):
        # PEP 563 — resolve the few names we use.
        t = {"int": int, "float": float, "str": str, "bool": bool,
             "List[str]": List[str], "list[str]": List[str],
             "List[int]": List[int], "list[int]": List[int],
             "Optional[int]": Optional[int],
             "Optional[str]": Optional[str]}.get(t, str)
    return t


def add_config_args(parser: argparse.ArgumentParser, cls: type) -> None:
    """Add one ``--flag`` per dataclass field, with matching type/default."""
    for f in dataclasses.fields(cls):
        t = _field_type(f)
        helpmsg = f.metadata.get("help", "") if f.metadata else ""
        names = ["--" + f.name]
        short = f.metadata.get("short") if f.metadata else None
        if short:
            names.insert(0, short)
        name = names  # unpacked below
        if f.default is not dataclasses.MISSING:
            default = f.default
        elif f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
            default = f.default_factory()  # type: ignore[misc]
        else:
            default = None
        if t is bool:
            if default:
                parser.add_argument(*name, dest=f.name,
                                    action="store_false", help=helpmsg)
            else:
                parser.add_argument(*name, dest=f.name,
                                    action="store_true", help=helpmsg)
        elif get_origin(t) in (list, List) or t in (List[str], List[int]):
            elem = (get_args(t) or (str,))[0]
            parser.add_argument(*name, dest=f.name, type=elem, nargs="+",
                                default=default, help=helpmsg)
        else:
            if get_origin(t) is not None:  # Optional[...]
                args = [a for a in get_args(t) if a is not type(None)]
                t = args[0] if args else str
            parser.add_argument(*name, dest=f.name, type=t, default=default,
                                help=helpmsg)


def config_from_args(cls: type, argv: Optional[Sequence[str]] = None):
    """The config of ``argv``; ``--dtype`` also sets the process-wide compute
    dtype (``set_compute_dtype``), as ``tpugan/utils/config.py:135-140``."""
    parser = argparse.ArgumentParser(prog=getattr(cls, "prog", cls.__name__))
    add_config_args(parser, cls)
    cfg = cls(**vars(parser.parse_args(argv)))
    set_compute_dtype(cfg)
    return cfg


def set_compute_dtype(cfg) -> None:
    """Wire ``cfg.dtype`` into the layers (``tpugan_torch.nn.layers``):
    bfloat16 runs the convolutions and linears in bf16 over float32 master
    weights, float32 (the default) runs everything in float32."""
    from tpugan_torch.nn.layers import resolve_dtype, set_default_compute_dtype

    set_default_compute_dtype(resolve_dtype(getattr(cfg, "dtype", "float32")))
