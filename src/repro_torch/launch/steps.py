"""The training step (the counterpart of ``repro.launch.steps``'s
``make_train_step``), on one process or under a data-parallel mesh.

A step computes the forward loss, the MeCeFO backward (technique I skips
the MHA backward, II recomputes the FFN, III takes the low-rank Wgrad
through kernel #6), eq. (1)'s rescale, clipping by the global norm and the
optimizer update.  It runs eagerly where the JAX package jits, and updates
params and moments in place (see ``optim/optimizers.py``).

Gradient accumulation (``parallel.accum``) splits the batch, ``keep`` and
``example_weight`` into contiguous micro-batches (the JAX package's split
on one data shard), sums their gradients in f32, each optionally rounded
to bf16 first (``parallel.grad_compression == "bf16"``), divides by
``accum``, and applies eq. (1), clipping and the update to the mean.

Under a mesh (``launch/mesh.py``, ``data`` axis of size W) every rank gets
the same global batch and NDB masks and computes on its contiguous rows
(``launch/specs.py``): its loss is its share of the global mean (the
token-weight sum and the MoE routing fractions are all-reduced in the
forward, ``parallel/collectives.py:StepSync``), so the ranks' gradients
sum to the global gradient.  They are all-reduced, or reduce-scattered
under FSDP, except the low-rank leaves ``degraded_sync`` already reduced
as their (r, m) factors.  Eq. (1) rescales with the global masks,
clipping takes the global norm, and AdamW updates each rank's shard.
Under FSDP the step gathers the whole params at its start and frees them
at its end.  Accumulation splits each rank's rows (the JAX package's
per-shard interleave); with bf16 compression each micro-gradient is
reduced in f32 and rounded to bf16, the rounding the JAX program applies
to the global micro-gradient.  A batch the mesh does not divide is not
sharded: every rank computes all of it, with the MoE grouping of W data
shards, and nothing is reduced.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import (
    MeCeFOConfig, ModelConfig, ParallelConfig, ShapeConfig, TrainConfig,
)
from repro_torch.core.grad_sync import rescale_skipped_grads
from repro_torch.core.ndb import NDBContext
from repro_torch.launch.mesh import mesh_shape_dict, n_dp_shards
from repro_torch.launch.specs import batch_axes_for, rows_of
from repro_torch.launch.state import ShardLayout, TrainState, shard_layout
from repro_torch.models.model import ExecFlags, forward_loss
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.optim.optimizers import apply_update, clip_by_global_norm, lr_schedule
from repro_torch.parallel.collectives import StepSync
from repro_torch.parallel.sharding import ShardingRules, default_rules

Tree = Any

NDB_MODES = ("off", "dynamic", "static", "degraded")


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v, device=device)
            for k, v in batch.items()}


def trunk_shape(batch: Dict) -> tuple:
    """(B, S) of the trunk's sequence: the tokens, the audio stub's frame
    embeddings, or the vision stub's patches followed by the tokens."""
    if "embeddings" in batch:
        return tuple(batch["embeddings"].shape[:2])
    B, S = batch["tokens"].shape
    if "patch_embeds" in batch:
        S += batch["patch_embeds"].shape[1]
    return (B, S)


def loss_and_grads(params: Tree, proj: Optional[Tree], batch: Dict, cfg: ModelConfig,
                   ctx: NDBContext, flags: ExecFlags, sync: Optional[StepSync] = None):
    """(loss, metrics, grads) of :func:`forward_loss`; ``grads`` has the
    params' structure and dtypes.  A leaf the backward never reaches (the
    MHA weights in the all-degraded program) gets a zero gradient, as JAX
    gives it.  With ``sync`` (a rank's share of a mesh step) the forward
    and backward reduce over its data group (it rides in ``ctx``), and
    ``sync.synced`` says per leaf whether the backward already reduced its
    gradient."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    leaves = tree_leaves(live)
    if sync is not None:
        sync.paths = {id(p): path for p, path in zip(leaves, sync.leaf_paths)}
        sync.reduced = {}
        ctx = dataclasses.replace(ctx, sync=sync)
    loss, metrics = forward_loss(live, proj, batch, cfg, ctx, flags)
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    if sync is not None:
        sync.synced = [id(p) in sync.reduced for p in leaves]
    by_id = {id(p): (g if g is not None else torch.zeros_like(p)) for p, g in zip(leaves, got)}
    grads = tree_map(lambda p: by_id[id(p)], live)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def accumulated_loss_and_grads(params: Tree, proj: Optional[Tree], batch: Dict,
                               cfg: ModelConfig, ctx: NDBContext, flags: ExecFlags,
                               accum: int, compression: str = "none",
                               reduce: Optional[Callable] = None,
                               sync: Optional[StepSync] = None):
    """(mean loss, metrics, grads) over ``accum`` contiguous micro-batches
    of ``batch`` (``keep`` and ``example_weight`` split alike): the f32 sum
    of the micro-batches' gradients, each rounded to bf16 first when
    ``compression == "bf16"``, divided by ``accum``.  ``metrics`` are the
    last micro-batch's with the mean loss, as the JAX package reports.
    Under a mesh ``reduce`` takes each micro-gradient across the ranks
    (before the rounding) and ``sync`` is the rank's step sync."""
    B = next(iter(batch.values())).shape[0]
    if B % accum:
        raise ValueError(f"batch {B} does not split into {accum} micro-batches")
    b = B // accum
    grads, loss_sum = None, None
    for i in range(accum):
        sl = slice(i * b, (i + 1) * b)
        mctx = ctx if ctx.keep is None else dataclasses.replace(
            ctx, keep=ctx.keep[:, sl], example_weight=ctx.example_weight[sl])
        loss, metrics, g = loss_and_grads(params, proj, {k: v[sl] for k, v in batch.items()},
                                          cfg, mctx, flags, sync)
        if reduce is not None:
            g = reduce(g)
        if compression == "bf16":  # each micro-gradient rounded as it would cross the wire
            g = tree_map(lambda a: a.to(torch.bfloat16), g)
        grads = (tree_map(lambda a: a.float(), g) if grads is None else
                 tree_map(lambda acc, a: acc.add_(a.float()), grads, g))
        loss_sum = loss.float() if loss_sum is None else loss_sum + loss
        del g
    loss = loss_sum / accum
    return loss, dict(metrics, loss=loss), tree_map(lambda a: a.div_(accum), grads)


def build_rules(cfg: ModelConfig, mesh, parallel: ParallelConfig) -> ShardingRules:
    """The sharding rules of ``cfg`` on ``mesh`` (the JAX package's, for the
    ``"tp_fsdp"`` mode the port runs)."""
    rules = default_rules(mesh, fsdp=parallel.fsdp, sequence_parallel=parallel.sequence_parallel,
                          n_kv_heads=cfg.n_kv_heads if cfg.family != "ssm" else 0)
    model_n = mesh_shape_dict(mesh).get("model", 1)
    hd = cfg.resolved_head_dim
    if (cfg.n_heads * hd) % model_n != 0:
        rules = dataclasses.replace(rules, heads=None)
    if (cfg.n_kv_heads * hd) % model_n != 0:
        rules = dataclasses.replace(rules, kv_heads=None)
    return rules


def mesh_layout(cfg: ModelConfig, mesh, parallel: Optional[ParallelConfig] = None) -> ShardLayout:
    """Where ``mesh``'s ranks cut ``cfg``'s params (whole without FSDP)."""
    parallel = parallel or ParallelConfig()
    parallel.check(mesh_shape_dict(mesh))
    return shard_layout(cfg, build_rules(cfg, mesh, parallel), mesh, parallel.fsdp)


def make_train_step(
    cfg: ModelConfig,
    train: TrainConfig,
    mecefo: MeCeFOConfig,
    shape: ShapeConfig,
    *,
    ndb_mode: str = "off",  # "off" | "dynamic" | "static" | "degraded"
    static_ndb=None,        # (keep, weight) arrays fixed for "static"
    total_steps: int = 1000,
    flags: Optional[ExecFlags] = None,
    device="cuda",
    parallel=None,
    mesh=None,
):
    """Returns ``step``:

      off/degraded/static:  step(state, batch)       -> (state, metrics)
      dynamic:              step(state, batch, ndb)  -> (state, metrics)

    ``batch`` holds ``tokens``/``labels`` (B, S), or a frontend stub's
    embeddings (``data.pipeline.make_batch``); ``metrics`` carry ``loss``,
    ``ce`` and the MoE ``aux`` loss; ``ndb`` holds ``keep``
    (L, B) and ``example_weight`` (B,), numpy or tensors.  ``flags``
    defaults to ``ExecFlags()`` (FFN recompute, the Trainer's default).
    The step runs on ``device`` (CUDA unless the caller asks for the CPU).
    ``parallel`` (any object with ``accum`` and, optionally,
    ``grad_compression``) sets gradient accumulation: ``accum``
    micro-batches a step, or one where the global batch does not divide;
    ``metrics`` then carry the mean loss and the last micro-batch's
    ``ce`` and ``aux``, as in the JAX package.

    ``mesh`` (``launch/mesh.py``) runs the step data-parallel on the mesh's
    device (``device`` is then unused; ``parallel`` defaults to
    ``ParallelConfig()``, FSDP on, as the JAX package's): ``state`` holds
    this rank's slices (``launch/state.py:to_local``, the whole state
    without FSDP), ``batch`` and ``ndb`` the global batch and masks.  The
    step carries ``layout`` (the :class:`ShardLayout`), ``rows`` (this
    rank's rows) and ``accum``.
    """
    if ndb_mode not in NDB_MODES:
        raise ValueError(f"ndb_mode {ndb_mode!r} not in {NDB_MODES}")
    B = shape.global_batch
    flags = flags or ExecFlags()
    layout = rows = None
    nds, sharded = 1, False
    if mesh is None:
        dev = resolve_device(device)
    else:
        parallel = parallel or ParallelConfig()
        layout = mesh_layout(cfg, mesh, parallel)
        dev = mesh.device
        nds = n_dp_shards(mesh)
        bax = batch_axes_for(B, build_rules(cfg, mesh, parallel), mesh_shape_dict(mesh))
        rows = rows_of(B, bax, mesh)
        sharded = bax is not None  # the ranks' shares combine in the forward and backward
        # a rank's rows are its MoE group; a whole batch routes in W groups
        flags = dataclasses.replace(flags, n_dp_shards=1 if sharded else nds)
    accum = max(getattr(parallel, "accum", 1), 1)
    if B % (nds * accum):
        accum = 1
    compress = getattr(parallel, "grad_compression", "none")
    schedule = lr_schedule(train, total_steps)
    static = None
    if ndb_mode == "static":
        if static_ndb is None:
            raise ValueError("ndb_mode 'static' needs static_ndb=(keep, weight)")
        static = (torch.as_tensor(np.asarray(static_ndb[0]), device=dev),
                  torch.as_tensor(np.asarray(static_ndb[1]), device=dev))

    def make_ctx(ndb) -> NDBContext:
        if ndb_mode in ("off", "degraded"):
            return NDBContext(mode=ndb_mode, mecefo=mecefo)
        if ndb_mode == "static":
            keep, w = static
        else:
            if ndb is None:
                raise ValueError("a dynamic step takes step(state, batch, ndb)")
            nd = to_device(ndb, dev)
            keep, w = nd["keep"], nd["example_weight"]
        return NDBContext(mode=ndb_mode, keep=keep, example_weight=w, mecefo=mecefo)

    def reduce_grads(grads: Tree, sync: Optional[StepSync]) -> Tree:
        """A rank's gradient shares as this rank's slices of the global
        gradient: all-reduced, or reduce-scattered under FSDP; a leaf the
        backward already reduced (or every leaf, when each rank computed
        the whole batch) is only cut."""
        comm = mesh.comm
        synced = sync.synced if sync is not None else [True] * len(layout.dims)

        def one(g, d, path, done):
            if done:
                return layout.local(g, d)
            if d is None:
                return comm.all_reduce(g, tag="grad:" + path)
            return comm.reduce_scatter(g, d, tag="grad:" + path)

        leaves = tree_leaves(grads)
        out = [one(*a) for a in zip(leaves, layout.dims, layout.paths, synced)]
        by_id = dict(zip(map(id, leaves), out))
        return tree_map(lambda g: by_id[id(g)], grads)

    def local_grads(state: TrainState, batch: Dict, ctx: NDBContext, proj):
        """(metrics, this rank's slices of the global gradient) under the
        mesh."""
        batch = {k: v[rows] for k, v in batch.items()}
        if ctx.keep is not None:
            ctx = dataclasses.replace(ctx, keep=ctx.keep[:, rows],
                                      example_weight=ctx.example_weight[rows])
        params = layout.gather(state.params, "param") if layout.sharded else state.params
        sync = StepSync(mesh.comm, layout.paths) if sharded else None
        if accum == 1:
            _loss, metrics, grads = loss_and_grads(params, proj, batch, cfg, ctx, flags, sync)
            grads = reduce_grads(grads, sync)
        else:
            _loss, metrics, grads = accumulated_loss_and_grads(
                params, proj, batch, cfg, ctx, flags, accum, compress,
                reduce=lambda g: reduce_grads(g, sync), sync=sync)
        if sync is not None:  # the shares' sums: the global batch's metrics
            metrics = {k: mesh.comm.all_reduce(v.detach().clone().reshape(1),
                                               tag="metrics")[0] for k, v in metrics.items()}
        return metrics, grads

    def step(state: TrainState, batch: Dict, ndb: Optional[Dict] = None):
        if ndb is not None and ndb_mode != "dynamic":
            raise ValueError(f"a {ndb_mode!r} step takes step(state, batch)")
        batch = to_device(batch, dev)
        want = (shape.global_batch, shape.seq_len)
        if trunk_shape(batch) != want:
            raise ValueError(f"trunk sequence {trunk_shape(batch)}, want {want} ({shape.name})")
        ctx = make_ctx(ndb)
        proj = state.proj if mecefo.mode != "off" else None
        if mesh is not None:
            metrics, grads = local_grads(state, batch, ctx, proj)
        elif accum == 1:
            _loss, metrics, grads = loss_and_grads(state.params, proj, batch, cfg, ctx, flags)
        else:
            _loss, metrics, grads = accumulated_loss_and_grads(
                state.params, proj, batch, cfg, ctx, flags, accum, compress)
        if mecefo.skip_mha_backward and ndb_mode in ("dynamic", "static"):
            # eq. (1) from the global masks, with |N_l|/n measured over live
            # examples only (an FSDP shard is cut off dim 0, the period dim
            # the rescale runs along)
            grads = rescale_skipped_grads(grads, ctx.keep, cfg, ctx.example_weight)
        if layout is not None and layout.sharded:  # a whole leaf counts on rank 0 only
            counted = [d is not None or mesh.rank == 0 for d in layout.dims]
            grads, gnorm = clip_by_global_norm(grads, train.grad_clip, mesh.comm, counted)
        else:
            grads, gnorm = clip_by_global_norm(grads, train.grad_clip)
        lr = schedule(state.step)
        params, opt = apply_update(state.params, grads, state.opt, lr, state.step, train)
        new_state = TrainState(step=state.step + 1, params=params, opt=opt, proj=state.proj)
        return new_state, dict(metrics, grad_norm=gnorm, lr=lr)

    step.layout, step.rows, step.accum = layout, rows, accum
    return step
