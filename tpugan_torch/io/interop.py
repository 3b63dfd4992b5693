"""Load JAX-package parameters into the port's modules.

``load_jax_params(module, params)`` takes a nested dict of numpy arrays, as
``jax.device_get(state.params["G_AB"])`` gives, and copies it into the
module. Pairing follows ``tpugan/io/torch_interop.py:export_state_dict``:
each ``state_dict`` entry, in registration order, takes the first unused
flax leaf of the same kind whose layout-transformed shape matches, the flax
leaves walked in insertion order (which is call order). This module repeats
that logic so the port does not import ``tpugan.io``, which imports JAX.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


def _walk(tree: Dict, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _flax_groups(params: Dict) -> Dict[str, List[np.ndarray]]:
    """Flax leaves by kind, in insertion order (``torch_interop.py:60-111``)."""
    groups: Dict[str, list] = {
        "conv_kernel": [], "conv_bias": [], "linear_kernel": [],
        "linear_bias": [], "norm_scale": [], "norm_bias": [],
    }
    leaves = list(_walk(params))
    owner = {}
    for path, leaf in leaves:
        name, nd = path[-1], np.ndim(leaf)
        if name == "kernel" and nd in (2, 4):
            kind = "conv_kernel" if nd == 4 else "linear_kernel"
        elif name == "scale":
            kind = "norm_scale"
        elif name == "bias":
            continue
        else:
            raise ValueError(f"flax param leaf {path} has no counterpart in the port")
        groups[kind].append(np.asarray(leaf))
        owner[path[:-1]] = kind
    for path, leaf in leaves:
        if path[-1] == "bias":
            kind = {"conv_kernel": "conv_bias", "linear_kernel": "linear_bias"}.get(
                owner.get(path[:-1]), "norm_bias"
            )
            groups[kind].append(np.asarray(leaf))
    return groups


def _torch_kind(sd, key: str) -> str:
    scope, _, base = key.rpartition(".")
    nd = sd[key].dim()
    if base == "weight":
        return {4: "conv_kernel", 2: "linear_kernel", 1: "norm_scale"}[nd]
    if base == "bias":
        wkey = f"{scope}.weight" if scope else "weight"
        return {4: "conv_bias", 2: "linear_bias", 1: "norm_bias"}[sd[wkey].dim()]
    raise ValueError(f"state_dict entry {key!r} has no flax counterpart")


def _to_torch(kind: str, a: np.ndarray) -> np.ndarray:
    """flax HWIO conv kernels to OIHW, (in, out) linear kernels to (out, in)
    (``torch_interop.py:_to_torch``)."""
    if kind == "conv_kernel":
        return a.transpose(3, 2, 0, 1)
    if kind == "linear_kernel":
        return a.T
    return a


@torch.no_grad()
def load_jax_params(module: torch.nn.Module, params: Dict) -> torch.nn.Module:
    """Copy flax ``params`` into ``module`` in place and return it. Raises on
    any entry without a counterpart and on leaves left over."""
    groups = _flax_groups(params)
    used = {k: [False] * len(v) for k, v in groups.items()}
    sd = module.state_dict()
    for key, tensor in sd.items():
        kind = _torch_kind(sd, key)
        pool = groups[kind]
        hit = next(
            (
                i for i, leaf in enumerate(pool)
                if not used[kind][i] and _to_torch(kind, leaf).shape == tuple(tensor.shape)
            ),
            None,
        )
        if hit is None:
            raise ValueError(f"{key!r} ({kind}, {tuple(tensor.shape)}) has no unused flax leaf")
        used[kind][hit] = True
        value = np.array(_to_torch(kind, pool[hit]), dtype=np.float32, order="C")
        tensor.copy_(torch.from_numpy(value))
    left = {k: flags.count(False) for k, flags in used.items() if not all(flags)}
    if left:
        raise ValueError(f"flax leaves left unmatched: {left}")
    return module
