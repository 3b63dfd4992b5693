"""Load JAX-package parameters into the port's modules.

``load_jax_params(module, params, batch_stats)`` takes nested dicts of numpy
arrays in flax's insertion order, as ``state.params["G_AB"]`` and
``state.model_state[...]`` hold them after ``init``, and copies them into the
module. The ``running_mean``/``running_var`` of BatchNorm and of the tracked
InstanceNorm (stargan) come from the flax ``batch_stats`` leaves
``mean``/``var``, paired in the same order; ``num_batches_tracked`` has no
flax counterpart and is left as it is.

Pairing follows ``tpugan/io/torch_interop.py:export_state_dict``: each
``state_dict`` entry, in registration order, takes the first unused flax leaf
of the same kind whose layout-transformed shape matches, the flax leaves
walked in insertion order (which is call order). ``jax.device_get``,
``jax.tree_util.tree_map`` and ``jit`` outputs sort dict keys instead
(``Conv_10`` before ``Conv_2``), which pairs wrongly once a scope holds more
than ten layers of one class, as MUNIT's MultiDiscriminator does: rebuild such
a tree in the order of the ``init`` params first. This module repeats the
pairing so the port does not import ``tpugan.io``, which imports JAX.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

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
        "linear_bias": [], "norm_scale": [], "norm_bias": [], "embedding": [],
        "prelu": [],
    }
    leaves = list(_walk(params))
    owner = {}
    for path, leaf in leaves:
        name, nd = path[-1], np.ndim(leaf)
        if name == "kernel" and nd in (2, 4):
            kind = "conv_kernel" if nd == 4 else "linear_kernel"
        elif name in ("scale", "gamma"):
            # gamma/beta: MUNIT's LayerNormSpatial affine, named so on both
            # sides (torch_interop.py:85-91).
            kind = "norm_scale"
        elif name == "beta":
            kind = "norm_bias"
        elif name == "embedding" and nd == 2:
            kind = "embedding"
        elif name == "alpha" and nd == 0:
            # PReLU's one slope (``tpugan/nn/layers.py:PReLU``): a lone 1-D
            # ``weight`` of shape (1,) in torch (``torch_interop.py:84-87``).
            kind = "prelu"
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


def _stat_groups(batch_stats: Dict) -> Dict[str, List[np.ndarray]]:
    """flax ``batch_stats`` leaves by kind, in insertion order."""
    groups: Dict[str, list] = {"bn_mean": [], "bn_var": []}
    for path, leaf in _walk(batch_stats):
        kind = {"mean": "bn_mean", "var": "bn_var"}.get(path[-1])
        if kind is None:
            raise ValueError(f"flax batch_stats leaf {path} has no counterpart in the port")
        groups[kind].append(np.asarray(leaf))
    return groups


def _torch_kind(sd, key: str) -> str:
    scope, _, base = key.rpartition(".")
    nd = sd[key].dim()
    if base in ("running_mean", "running_var"):
        return "bn_" + base[len("running_"):]
    if base in ("gamma", "beta"):
        return {"gamma": "norm_scale", "beta": "norm_bias"}[base]
    if base == "weight":
        if nd == 2 and (f"{scope}.bias" if scope else "bias") not in sd:
            # A 2-D weight without a sibling bias is an Embedding's table
            # (``torch_interop.py:77-78,132-134``): not transposed.
            return "embedding"
        if nd == 1 and (f"{scope}.bias" if scope else "bias") not in sd:
            # A 1-D weight without a sibling bias is a PReLU slope: every
            # affine norm of the zoo has its bias.
            return "prelu"
        return {4: "conv_kernel", 2: "linear_kernel", 1: "norm_scale"}[nd]
    if base == "bias":
        wkey = f"{scope}.weight" if scope else "weight"
        return {4: "conv_bias", 2: "linear_bias", 1: "norm_bias"}[sd[wkey].dim()]
    raise ValueError(f"state_dict entry {key!r} has no flax counterpart")


def _to_torch(kind: str, a: np.ndarray) -> np.ndarray:
    """flax HWIO conv kernels to OIHW, (in, out) linear kernels to (out, in)
    and a PReLU's scalar slope to shape (1,) (``torch_interop.py:_to_torch``)."""
    if kind == "conv_kernel":
        return a.transpose(3, 2, 0, 1)
    if kind == "linear_kernel":
        return a.T
    if kind == "prelu":
        return np.reshape(a, (1,))
    return a


@torch.no_grad()
def load_jax_params(
    module: torch.nn.Module, params: Dict, batch_stats: Optional[Dict] = None
) -> torch.nn.Module:
    """Copy flax ``params`` (and ``batch_stats``, for a module with
    BatchNorm) into ``module`` in place and return it. Raises on any entry
    without a counterpart and on leaves left over. A module with a
    ``load_flax_params(params)`` of its own (the VGG features, whose
    parameters pair by name) loads through it instead."""
    own = getattr(module, "load_flax_params", None)
    if own is not None:
        own(params)
        return module
    groups = {**_flax_groups(params), **_stat_groups(batch_stats or {})}
    used = {k: [False] * len(v) for k, v in groups.items()}
    sd = module.state_dict()
    for key, tensor in sd.items():
        if key.rpartition(".")[2] == "num_batches_tracked":
            continue
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
