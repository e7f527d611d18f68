"""Technique III: the low-rank FFN weight gradient (paper eq. (2)); the
counterpart of ``repro.core.lowrank``.

For ``y = x @ W`` with ``W`` (n, m), the exact weight gradient is
``dW = x^T dy``.  MeCeFO approximates it by projecting onto the top-r
input-space singular subspace of W (``V1`` (n, r), refreshed every τ
steps)::

    dW ≈ V1 @ ((x @ V1)^T dy)

``(x @ V1)^T dy`` is kernel #6 (``kernels/lowrank_wgrad.py``), launched
inside the backward of :func:`lowrank_linear`.  In ``degraded_sync`` mode
(MeCeFO's ``lowrank_sync``) the step's data group all-reduces that (r, m)
factor instead of the (n, m) gradient: the backward sums it over the
ranks before ``V1 @ A``, and marks the weight's gradient as global so the
step does not reduce it again (``parallel/collectives.py:StepSync``).
Under a ``model`` axis a row-parallel weight (``w_down``, whose input
columns and V1 rows are this rank's ``mlp`` shard) has A = Σ_m (x_m
V1_m)ᵀ dy: kernel #6 on the local shard gives a partial (r, m) factor,
all-reduced over the model group before dW_m = V1_m A (in ``degraded``
and in ``mixed``'s low-rank part), or over the world (data and model at
once) in ``degraded_sync``.  A column-parallel weight's factor is whole
on its rank and crosses no model collective.  The MoE experts' grouped
form, :func:`lowrank_linear_grouped`, takes batched matrix products, as the
JAX package's ``einsum`` outside any Pallas kernel.  ``dx`` is always
exact.
As in the JAX package, ``V1`` holds the top *left* singular vectors of the
stored (n, m) matrix.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.lowrank_wgrad import lowrank_wgrad
from repro_torch.models.params import block_layout, param_annotations
from repro_torch.obs.spans import span
from repro_torch.parallel import collectives

Tree = Any

MODES = ("exact", "degraded", "degraded_sync", "mixed")


@torch.no_grad()
def svd_projection(w: torch.Tensor, rank: int) -> torch.Tensor:
    """Top-``rank`` input-space singular vectors of a stacked weight
    (..., n, m) -> (..., n, r).  Computed in f32, cast back; a stack of
    expert weights ``(n_periods, E, n, m)`` one period at a time, so only
    one period's f32 copy exists at once."""
    if w.dim() == 4:
        return torch.stack([svd_projection(wi, rank) for wi in w.unbind(0)])
    rank = min(rank, w.shape[-2], w.shape[-1])
    if rank == 0:  # a zero-width leaf (mamba2's d_ff = 0 FFN): no subspace
        return w.new_zeros(*w.shape[:-1], 0)
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
    steps), in the span ``mecefo.v1_refresh``."""
    with span("mecefo.v1_refresh"):
        return _projection_tree(params, cfg, lambda w: svd_projection(w, rank))


def init_projections(params: Tree, cfg: ModelConfig, rank: int) -> Tree:
    """Zero V1 tree (valid before the first τ-refresh)."""

    def zeros(w):
        r = min(rank, w.shape[-2], w.shape[-1])
        return torch.zeros(*w.shape[:-1], r, dtype=w.dtype, device=w.device)

    return _projection_tree(params, cfg, zeros)


def projection_annotations(cfg: ModelConfig) -> Tree:
    """Logical sharding annotations of the V1 tree: the input dim follows
    W's, the rank dim is replicated."""
    anns = param_annotations(cfg)
    layers = []
    for pos, (kind, _is_moe) in enumerate(block_layout(cfg)):
        block = anns["layers"][pos]
        out = {"mixer": {}, "ffn": {}}
        for part in ("mixer", "ffn"):
            for name in _lowrank_leaf_names(kind, part):
                if name in block[part]:
                    out[part][name] = (*block[part][name][:-1], None)
        layers.append(out)
    return {"layers": tuple(layers)}


def _reducer(sync, w, comm, kind: str):
    """The all-reduce over ``comm`` of the (r, m) factor of weight ``w``:
    ``kind`` "lowrank" is the batch's sum (``degraded_sync``), which marks
    the weight's gradient as global; "lowrank_row" a row-parallel weight's
    sum over the model group."""
    leaf = collectives.leaf_id(w)
    tag = f"{kind}:{sync.paths.get(leaf, '?')}"

    def reduce(a: torch.Tensor) -> torch.Tensor:
        comm.all_reduce(a, tag=tag)
        if kind == "lowrank":
            sync.mark(leaf)
        return a

    return reduce


class LowRankLinear(torch.autograd.Function):
    """``y = x @ w`` with a MeCeFO backward for dW (``_ll_bwd``)."""

    @staticmethod
    def forward(ctx, x, w, v1, keep, mode, sync, row):
        if mode not in MODES:
            raise ValueError(mode)
        ctx.mode = mode
        row = row and sync is not None and sync.tp is not None
        # without a step sync over the batch (one process, or ranks that
        # each compute the whole batch) "degraded_sync" is "degraded"
        synced = mode == "degraded_sync" and sync is not None and sync.comm is not None
        # mixed's low-rank part sums over the model group only
        ctx.reduce_row = _reducer(sync, w, sync.tp.comm, "lowrank_row") if row else None
        # degraded_sync's over the batch's group, and the model group with it
        ctx.reduce = (_reducer(sync, w, sync.batch_model_comm if row else sync.comm, "lowrank")
                      if synced else ctx.reduce_row)
        ctx.keep_const = None if torch.is_tensor(keep) else float(keep)
        ctx.save_for_backward(x, w, v1, *((keep,) if torch.is_tensor(keep) else ()))
        return x @ w

    @staticmethod
    def backward(ctx, dy):
        x, w, v1, *rest = ctx.saved_tensors
        dx = dy @ w.T if ctx.needs_input_grad[0] else None
        if not ctx.needs_input_grad[1]:
            return dx, None, None, None, None, None, None
        # flatten, not reshape(-1, n): a zero-width FFN's (B, S, 0) has no -1
        xf = x.flatten(0, -2)
        dyf = dy.flatten(0, -2).contiguous()
        if ctx.mode == "exact":
            dw = xf.T @ dyf
        elif ctx.mode in ("degraded", "degraded_sync"):
            dw = lowrank_wgrad(xf, dyf, v1, reduce=ctx.reduce)
        else:  # mixed: kept examples exact, skipped ones low-rank
            keep = rest[0] if rest else torch.tensor(ctx.keep_const, device=dy.device)
            k = keep.to(dy.dtype)
            k = k.reshape(k.shape + (1,) * (dy.dim() - k.dim())) if k.dim() else k
            dy_keep = (dy * k).flatten(0, -2)
            dy_skip = (dy * (1 - k)).flatten(0, -2)
            dw = xf.T @ dy_keep + lowrank_wgrad(xf, dy_skip, v1, reduce=ctx.reduce_row)
        return dx, dw.to(w.dtype), None, None, None, None, None


def lowrank_linear(x: torch.Tensor, w: torch.Tensor, v1: torch.Tensor, keep,
                   mode: str = "exact", sync=None, row: bool = False) -> torch.Tensor:
    """``y = x @ w`` with a MeCeFO backward for dW.

    x: (..., n) activations (batch on dim 0); w: (n, m); v1: (n, r)
    (unused in ``exact`` mode); keep: (B,) per-example keep mask (1 =
    exact), used by ``mixed`` only; mode: "exact" | "degraded" |
    "degraded_sync" | "mixed"; sync: the rank's ``StepSync`` under a mesh,
    whose batch group ``degraded_sync`` all-reduces the factor over (without
    one it is ``degraded``); row: ``w`` is this rank's rows of a
    row-parallel weight (``v1`` its matching rows), whose factor sums over
    the model group.
    """
    return LowRankLinear.apply(x, w, v1, keep, mode, sync, row)


class LowRankLinearGrouped(torch.autograd.Function):
    """Grouped ``y[e] = x[e] @ w[e]`` with the MeCeFO backward per expert
    (``_llg_bwd``)."""

    @staticmethod
    def forward(ctx, x, w, v1, keep, mode, sync):
        if mode not in MODES:
            raise ValueError(mode)
        ctx.mode = mode
        # the experts' gradient shares sum over sync.expert_comm
        synced = mode == "degraded_sync" and sync is not None and sync.expert_comm is not None
        ctx.reduce = _reducer(sync, w, sync.expert_comm, "lowrank") if synced else None
        ctx.save_for_backward(x, w, v1, keep)
        return torch.bmm(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w, v1, keep = ctx.saved_tensors
        dy = dy.contiguous()
        dx = torch.bmm(dy, w.transpose(1, 2)) if ctx.needs_input_grad[0] else None
        if not ctx.needs_input_grad[1]:
            return dx, None, None, None, None, None
        xt = x.transpose(1, 2)
        if ctx.mode == "exact":
            dw = torch.bmm(xt, dy)
        elif ctx.mode in ("degraded", "degraded_sync"):
            a = torch.bmm(torch.bmm(x, v1).transpose(1, 2), dy)     # (E, r, m)
            if ctx.reduce is not None:
                a = ctx.reduce(a)
            dw = torch.bmm(v1, a)
        else:  # mixed: slots of kept examples exact, skipped ones low-rank
            k = keep.to(dy.dtype)[..., None]
            a = torch.bmm(torch.bmm(x, v1).transpose(1, 2), dy * (1 - k))
            dw = torch.bmm(xt, dy * k) + torch.bmm(v1, a)
        return dx, dw.to(w.dtype), None, None, None, None


def lowrank_linear_grouped(x: torch.Tensor, w: torch.Tensor, v1: torch.Tensor,
                           keep: torch.Tensor, mode: str = "exact", sync=None) -> torch.Tensor:
    """Grouped ``y[e] = x[e] @ w[e]`` with a MeCeFO backward per expert.

    x: (E, C, n); w: (E, n, m); v1: (E, n, r); keep: (E, C) slot mask
    (1 = the slot's example is exact), used by ``mixed`` only; mode as
    :func:`lowrank_linear`.
    """
    return LowRankLinearGrouped.apply(x, w, v1, keep, mode, sync)


def wgrad_flops(b: int, n: int, m: int, r: Optional[int]) -> int:
    """Wgrad FLOPs, exact (r None) vs low-rank (paper §3.4)."""
    if r is None:
        return 2 * b * m * n
    return 2 * b * r * n + 2 * b * r * m + 2 * r * m * n
