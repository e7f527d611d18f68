"""numpy bridge between the JAX package's parameter trees and the port's.

The JAX side hands its trees over as numpy arrays (``np.asarray`` of each
leaf); nothing here imports JAX.  A bf16 leaf arrives as an ``ml_dtypes``
bfloat16 array, which ``torch.from_numpy`` rejects, so it crosses as its
``uint16`` bit pattern and is viewed back as ``torch.bfloat16``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import map_leaves, param_shapes

Tree = Any


def tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # torch tensors may be written to
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # the dtype numpy uses for bf16; only this path needs it

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_numpy(tree: Tree, cfg: ModelConfig, device="cuda") -> Tree:
    """The JAX package's params (numpy leaves) as the port's tensors, with
    every leaf's shape checked against :func:`param_shapes`."""
    dev = resolve_device(device)
    shapes = param_shapes(cfg)
    out = {}
    for key, want in shapes.items():
        if key == "layers":
            got = tuple(tree["layers"])
            if len(got) != len(want):
                raise ValueError(f"layers: {len(got)} period positions, want {len(want)}")
            out[key] = tuple(
                {part: {k: _leaf(g[part][k], s, f"layers.{part}.{k}", dev)
                        for k, s in w[part].items()} for part in w}
                for g, w in zip(got, want)
            )
        else:
            out[key] = _leaf(tree[key], want, key, dev)
    return out


def _leaf(a, shape, name, dev) -> torch.Tensor:
    a = np.asarray(a)
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {a.shape}, want {shape}")
    return tensor_from_numpy(a, dev)


def params_to_numpy(params: Tree) -> Tree:
    """Inverse of :func:`params_from_numpy`: the port's tree as numpy."""
    return map_leaves(lambda _name, t: tensor_to_numpy(t), params)


__all__ = ["params_from_numpy", "params_to_numpy", "tensor_from_numpy", "tensor_to_numpy"]
