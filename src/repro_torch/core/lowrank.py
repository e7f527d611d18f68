"""Technique III: the low-rank FFN weight gradient (paper eq. (2)); the
counterpart of ``repro.core.lowrank``.

For ``y = x @ W`` with ``W`` (n, m), the exact weight gradient is
``dW = x^T dy``.  MeCeFO approximates it by projecting onto the top-r
input-space singular subspace of W (``V1`` (n, r), refreshed every τ
steps)::

    dW ≈ V1 @ ((x @ V1)^T dy)

``(x @ V1)^T dy`` is kernel #6 (``kernels/lowrank_wgrad.py``), launched
inside the backward of :func:`lowrank_linear`.  ``dx`` is always exact.
As in the JAX package, ``V1`` holds the top *left* singular vectors of the
stored (n, m) matrix.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.lowrank_wgrad import lowrank_wgrad
from repro_torch.models.params import block_layout

Tree = Any

MODES = ("exact", "degraded", "degraded_sync", "mixed")


@torch.no_grad()
def svd_projection(w: torch.Tensor, rank: int) -> torch.Tensor:
    """Top-``rank`` input-space singular vectors of a stacked weight
    (..., n, m) -> (..., n, r).  Computed in f32, cast back."""
    rank = min(rank, w.shape[-2], w.shape[-1])
    u, _s, _vh = torch.linalg.svd(w.float(), full_matrices=False)
    return u[..., :, :rank].to(w.dtype).contiguous()


_LOWRANK_FFN = ("w_gate", "w_up", "w_down")
_LOWRANK_SSM = ("in_proj", "out_proj")


def _lowrank_leaf_names(kind: str, part: str):
    if part == "ffn":
        return _LOWRANK_FFN
    if part == "mixer" and kind == "ssm":
        return _LOWRANK_SSM
    return ()


def _projection_tree(params: Tree, cfg: ModelConfig, leaf) -> Tree:
    layers = []
    for pos, (kind, _is_moe) in enumerate(block_layout(cfg)):
        block = params["layers"][pos]
        out = {"mixer": {}, "ffn": {}}
        for part in ("mixer", "ffn"):
            for name in _lowrank_leaf_names(kind, part):
                if name in block[part]:
                    out[part][name] = leaf(block[part][name])
        layers.append(out)
    return {"layers": tuple(layers)}


def refresh_projections(params: Tree, cfg: ModelConfig, rank: int) -> Tree:
    """(Re)compute the V1 tree from the current params (Alg. 3, every τ
    steps)."""
    return _projection_tree(params, cfg, lambda w: svd_projection(w, rank))


def init_projections(params: Tree, cfg: ModelConfig, rank: int) -> Tree:
    """Zero V1 tree (valid before the first τ-refresh)."""

    def zeros(w):
        r = min(rank, w.shape[-2], w.shape[-1])
        return torch.zeros(*w.shape[:-1], r, dtype=w.dtype, device=w.device)

    return _projection_tree(params, cfg, zeros)


class LowRankLinear(torch.autograd.Function):
    """``y = x @ w`` with a MeCeFO backward for dW (``_ll_bwd``)."""

    @staticmethod
    def forward(ctx, x, w, v1, keep, mode):
        if mode not in MODES:
            raise ValueError(mode)
        ctx.mode = mode
        ctx.keep_const = None if torch.is_tensor(keep) else float(keep)
        ctx.save_for_backward(x, w, v1, *((keep,) if torch.is_tensor(keep) else ()))
        return x @ w

    @staticmethod
    def backward(ctx, dy):
        x, w, v1, *rest = ctx.saved_tensors
        dx = dy @ w.T if ctx.needs_input_grad[0] else None
        if not ctx.needs_input_grad[1]:
            return dx, None, None, None, None
        xf = x.reshape(-1, x.shape[-1])
        dyf = dy.reshape(-1, dy.shape[-1]).contiguous()
        if ctx.mode == "exact":
            dw = xf.T @ dyf
        elif ctx.mode in ("degraded", "degraded_sync"):
            # On one device "degraded_sync" is "degraded": the JAX package's
            # _replicate, which moves the DP all-reduce onto the factored
            # (r, m) gradient, is a no-op without a mesh.  The factored
            # all-reduce belongs to the multi-GPU slice.
            dw = lowrank_wgrad(xf, dyf, v1)
        else:  # mixed: kept examples exact, skipped ones low-rank
            keep = rest[0] if rest else torch.tensor(ctx.keep_const, device=dy.device)
            k = keep.to(dy.dtype)
            k = k.reshape(k.shape + (1,) * (dy.dim() - k.dim())) if k.dim() else k
            dy_keep = (dy * k).reshape(-1, dy.shape[-1])
            dy_skip = (dy * (1 - k)).reshape(-1, dy.shape[-1])
            dw = xf.T @ dy_keep + lowrank_wgrad(xf, dy_skip, v1)
        return dx, dw.to(w.dtype), None, None, None


def lowrank_linear(x: torch.Tensor, w: torch.Tensor, v1: torch.Tensor, keep,
                   mode: str = "exact") -> torch.Tensor:
    """``y = x @ w`` with a MeCeFO backward for dW.

    x: (..., n) activations (batch on dim 0); w: (n, m); v1: (n, r)
    (unused in ``exact`` mode); keep: (B,) per-example keep mask (1 =
    exact), used by ``mixed`` only; mode: "exact" | "degraded" |
    "degraded_sync" | "mixed".
    """
    return LowRankLinear.apply(x, w, v1, keep, mode)


def wgrad_flops(b: int, n: int, m: int, r: Optional[int]) -> int:
    """Wgrad FLOPs, exact (r None) vs low-rank (paper §3.4)."""
    if r is None:
        return 2 * b * m * n
    return 2 * b * r * n + 2 * b * r * m + 2 * r * m * n
