"""numpy bridge between the JAX package's parameter trees and training
states and the port's.

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
from repro_torch.launch.state import TrainState
from repro_torch.models.params import map_leaves, param_shapes, tree_map
from repro_torch.optim.optimizers import AdamWState, SGDMState

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


def state_from_numpy(state, cfg: ModelConfig, device="cuda") -> TrainState:
    """A JAX ``TrainState`` with numpy leaves (``jax.tree.map(np.asarray,
    state)``) as the port's: params, the optimizer moments (AdamW ``m``/``v``
    or SGDM ``m``), the V1 tree ``proj`` and ``step``.  Read by attribute,
    so any object with those fields will do."""
    dev = resolve_device(device)
    params = params_from_numpy(state.params, cfg, dev)
    opt = state.opt
    if hasattr(opt, "v"):
        opt = AdamWState(m=params_from_numpy(opt.m, cfg, dev), v=params_from_numpy(opt.v, cfg, dev))
    else:
        opt = SGDMState(m=params_from_numpy(opt.m, cfg, dev))
    proj = {}
    if state.proj:
        layers = []
        for pos, blk in enumerate(state.proj["layers"]):
            out = {}
            for part in ("mixer", "ffn"):
                out[part] = {}
                for k, a in blk[part].items():
                    w = params["layers"][pos][part][k]
                    a = np.asarray(a)
                    if a.shape[:-1] != tuple(w.shape[:-1]):
                        raise ValueError(f"proj {part}.{k}: shape {a.shape}, weight {tuple(w.shape)}")
                    out[part][k] = tensor_from_numpy(a, dev)
            layers.append(out)
        proj = {"layers": tuple(layers)}
    return TrainState(step=int(np.asarray(state.step)), params=params, opt=opt, proj=proj)


def state_to_numpy(state: TrainState) -> TrainState:
    """Inverse of :func:`state_from_numpy`: the port's state with numpy
    leaves."""
    opt = type(state.opt)(*(tree_map(tensor_to_numpy, t) for t in state.opt))
    return TrainState(step=state.step, params=tree_map(tensor_to_numpy, state.params), opt=opt,
                      proj=tree_map(tensor_to_numpy, state.proj) if state.proj else {})


__all__ = ["params_from_numpy", "params_to_numpy", "state_from_numpy", "state_to_numpy",
           "tensor_from_numpy", "tensor_to_numpy"]
