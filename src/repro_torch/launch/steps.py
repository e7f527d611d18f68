"""The training step (the counterpart of ``repro.launch.steps``'s
``make_train_step``) on one device.

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
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import MeCeFOConfig, ModelConfig, ShapeConfig, TrainConfig
from repro_torch.core.grad_sync import rescale_skipped_grads
from repro_torch.core.ndb import NDBContext
from repro_torch.launch.state import TrainState
from repro_torch.models.model import ExecFlags, forward_loss
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.optim.optimizers import apply_update, clip_by_global_norm, lr_schedule

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
                   ctx: NDBContext, flags: ExecFlags):
    """(loss, metrics, grads) of :func:`forward_loss`; ``grads`` has the
    params' structure and dtypes.  A leaf the backward never reaches (the
    MHA weights in the all-degraded program) gets a zero gradient, as JAX
    gives it."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = forward_loss(live, proj, batch, cfg, ctx, flags)
    leaves = tree_leaves(live)
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_id = {id(p): (g if g is not None else torch.zeros_like(p)) for p, g in zip(leaves, got)}
    grads = tree_map(lambda p: by_id[id(p)], live)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def accumulated_loss_and_grads(params: Tree, proj: Optional[Tree], batch: Dict,
                               cfg: ModelConfig, ctx: NDBContext, flags: ExecFlags,
                               accum: int, compression: str = "none"):
    """(mean loss, metrics, grads) over ``accum`` contiguous micro-batches
    of ``batch`` (``keep`` and ``example_weight`` split alike): the f32 sum
    of the micro-batches' gradients, each rounded to bf16 first when
    ``compression == "bf16"``, divided by ``accum``.  ``metrics`` are the
    last micro-batch's with the mean loss, as the JAX package reports."""
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
                                          cfg, mctx, flags)
        if compression == "bf16":  # each micro-gradient rounded as it would cross the wire
            g = tree_map(lambda a: a.to(torch.bfloat16), g)
        grads = (tree_map(lambda a: a.float(), g) if grads is None else
                 tree_map(lambda acc, a: acc.add_(a.float()), grads, g))
        loss_sum = loss.float() if loss_sum is None else loss_sum + loss
        del g
    loss = loss_sum / accum
    return loss, dict(metrics, loss=loss), tree_map(lambda a: a.div_(accum), grads)


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
    """
    if ndb_mode not in NDB_MODES:
        raise ValueError(f"ndb_mode {ndb_mode!r} not in {NDB_MODES}")
    accum = max(getattr(parallel, "accum", 1), 1)
    if shape.global_batch % accum:  # one data shard: B % (nds * accum)
        accum = 1
    compress = getattr(parallel, "grad_compression", "none")
    dev = resolve_device(device)
    flags = flags or ExecFlags()
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

    def step(state: TrainState, batch: Dict, ndb: Optional[Dict] = None):
        if ndb is not None and ndb_mode != "dynamic":
            raise ValueError(f"a {ndb_mode!r} step takes step(state, batch)")
        batch = to_device(batch, dev)
        want = (shape.global_batch, shape.seq_len)
        if trunk_shape(batch) != want:
            raise ValueError(f"trunk sequence {trunk_shape(batch)}, want {want} ({shape.name})")
        ctx = make_ctx(ndb)
        proj = state.proj if mecefo.mode != "off" else None
        if accum == 1:
            _loss, metrics, grads = loss_and_grads(state.params, proj, batch, cfg, ctx, flags)
        else:
            _loss, metrics, grads = accumulated_loss_and_grads(
                state.params, proj, batch, cfg, ctx, flags, accum, compress)
        if mecefo.skip_mha_backward and ndb_mode in ("dynamic", "static"):
            # eq. (1), with |N_l|/n measured over live examples only
            grads = rescale_skipped_grads(grads, ctx.keep, cfg, ctx.example_weight)
        grads, gnorm = clip_by_global_norm(grads, train.grad_clip)
        lr = schedule(state.step)
        params, opt = apply_update(state.params, grads, state.opt, lr, state.step, train)
        new_state = TrainState(step=state.step + 1, params=params, opt=opt, proj=state.proj)
        return new_state, dict(metrics, grad_norm=gnorm, lr=lr)

    return step
