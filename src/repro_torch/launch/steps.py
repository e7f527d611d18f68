"""The training step and the serve steps (the counterparts of
``repro.launch.steps``'s ``make_train_step``, ``make_prefill_step``,
``make_decode_step`` and ``default_accum``), on one process or over a
(data, model) or (pod, data, model) mesh.

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

Under a mesh (``launch/mesh.py``, axes ``data`` × ``model``, or ``pod`` ×
``data`` × ``model``) every rank gets the same global batch and NDB masks
and computes on the rows its batch axes give it (``launch/specs.py``:
``d`` of D under ``sharding_mode="tp_fsdp"``, ``d·M + m`` of D·M under
``"fsdp"``; with a pod axis ``p·D + d`` of P·D and ``(p·D + d)·M + m`` of
P·D·M): its loss is its share of the global mean (the token-weight sum and the MoE
routing fractions are all-reduced in the forward,
``parallel/collectives.py:StepSync``).  A ``model`` axis above 1 cuts the
layers (``model_axis``: tensor parallelism over heads, FFN and vocab,
sequence parallelism, the experts, the SSM mixer by its heads) as
``models/layers.py``, ``models/moe.py`` and ``models/ssm.py`` describe; the model ranks of one data row then hold the
same rows and the same loss.  A leaf's gradient shares are summed over
the batch's groups in a pod except ``model`` where the leaf is cut over it
(all-reduced, or reduce-scattered along its FSDP dim), then all-reduced
over ``pod`` where the batch is cut over it, except the
low-rank leaves ``degraded_sync`` already reduced as their (r, m)
factors.  Eq. (1) rescales with the global masks, clipping takes the
global norm (each distinct slice counted once, the slices of pod 0),
and AdamW updates each rank's slices.  The step never holds the whole
params: the forward gathers a layer's FSDP dims where the layer reads
them and the backward again where it needs them
(``parallel/fsdp.py:LayerGather``), and each gathered gradient is reduced
in its pod to this rank's slice as soon as its layer's backward forms it
(reduce-scattered over the FSDP group, or all-reduced and cut); the
leaves FSDP leaves whole, and the ``pod`` all-reduce of every leaf, wait
for the end of the backward.  It never gathers a ``model`` dim.
Accumulation splits each rank's rows (the JAX package's per-shard
interleave); with bf16 compression each micro-gradient is reduced in f32
and rounded to bf16, the rounding the JAX program applies to the global
micro-gradient.  A batch the mesh does not divide is not sharded: every
rank computes all of it, with the MoE grouping of the mesh's shards, and
nothing is reduced over the batch.

The serve steps run ``forward_prefill`` / ``forward_decode`` under the same
mesh, layout and model axis with ``remat="none"``, on params alone (no
optimizer state), gathering a layer's FSDP dims where it reads them (a
decode call gathers every layer once): each rank serves its rows, holds
its caches' KV heads and returns its logits' vocabulary columns; no
logits are gathered for a decode loop (``serve/sampling.py:greedy_token``
takes the ids over the model group).
"""
from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import (
    MeCeFOConfig, ModelConfig, ParallelConfig, ShapeConfig, TrainConfig,
)
from repro_torch.core.grad_sync import rescale_skipped_grads
from repro_torch.core.ndb import NDBContext
from repro_torch.launch.mesh import AXES, mesh_shape_dict, n_dp_shards
from repro_torch.launch.specs import batch_axes_for, input_specs, rows_of
from repro_torch.launch.state import ShardLayout, TrainState, shard_layout
from repro_torch.models.kvcache import (
    cache_annotations, cache_structs, held_kv_heads, held_ssm_heads,
)
from repro_torch.models.model import ExecFlags, forward_decode, forward_loss, forward_prefill
from repro_torch.models.params import count_params, param_annotations, tree_leaves, tree_map
from repro_torch.obs.spans import span
from repro_torch.optim.optimizers import apply_update, clip_by_global_norm, lr_schedule
from repro_torch.parallel.collectives import ModelAxis, StepSync
from repro_torch.parallel.fsdp import LayerGather
from repro_torch.parallel.sharding import (
    ShardingRules, Spec, default_rules, held_cache_spec, spec_tree,
)

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
                   ctx: NDBContext, flags: ExecFlags, sync: Optional[StepSync] = None,
                   fsdp: Optional[LayerGather] = None):
    """(loss, metrics, grads) of :func:`forward_loss`; ``grads`` has the
    params' structure and dtypes.  A leaf the backward never reaches (the
    MHA weights in the all-degraded program) gets a zero gradient, as JAX
    gives it.  With ``sync`` (a rank's share of a mesh step) the forward
    and backward reduce over its data group (it rides in ``ctx``), and
    ``sync.synced`` says per leaf whether the backward already reduced its
    gradient.  With ``fsdp`` the params are this rank's slices, gathered
    where they are read, and so are the FSDP leaves' gradients (reduced in
    the pod by the gather's backward)."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    leaves = tree_leaves(live)
    if sync is not None:
        sync.paths = {id(p): path for p, path in zip(leaves, sync.leaf_paths)}
        sync.reduced = {}
        ctx = dataclasses.replace(ctx, sync=sync)
    with span("train.forward"):
        loss, metrics = forward_loss(live, proj, batch, cfg, ctx, flags, fsdp=fsdp)
    with span("train.backward"):
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
                               sync: Optional[StepSync] = None,
                               fsdp: Optional[LayerGather] = None):
    """(mean loss, metrics, grads) over ``accum`` contiguous micro-batches
    of ``batch`` (``keep`` and ``example_weight`` split alike): the f32 sum
    of the micro-batches' gradients, each rounded to bf16 first when
    ``compression == "bf16"``, divided by ``accum``.  ``metrics`` are the
    last micro-batch's with the mean loss, as the JAX package reports.
    Under a mesh ``reduce`` takes each micro-gradient across the ranks
    (before the rounding), ``sync`` is the rank's step sync and ``fsdp``
    its gather (:func:`loss_and_grads`)."""
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
                                          cfg, mctx, flags, sync, fsdp)
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
    """The sharding rules of ``cfg`` on ``mesh`` (the JAX package's, the
    pure 2-D ``"fsdp"`` mode included: the batch over every axis, the
    weights' ``embed`` dim over both, ``expert`` left on ``model``)."""
    rules = default_rules(mesh, fsdp=parallel.fsdp, sequence_parallel=parallel.sequence_parallel,
                          n_kv_heads=cfg.n_kv_heads if cfg.family != "ssm" else 0)
    msd = mesh_shape_dict(mesh)
    model_n = msd.get("model", 1)
    hd = cfg.resolved_head_dim
    if (cfg.n_heads * hd) % model_n != 0:
        rules = dataclasses.replace(rules, heads=None)
    if (cfg.n_kv_heads * hd) % model_n != 0:
        rules = dataclasses.replace(rules, kv_heads=None)
    if parallel.sharding_mode == "fsdp":
        both = tuple(a for a in ("data", "model") if a in msd)
        rules = dataclasses.replace(
            rules, batch=tuple(a for a in ("pod", "data", "model") if a in msd),
            dispatch=tuple(a for a in ("pod", "data") if a in msd),
            heads=None, kv_heads=None, kv_cache=None, mlp=None, ssm_inner=None, vocab=None,
            embed=both if parallel.fsdp else None)
    return rules


# the batch axes the port cuts a batch over
BATCH_AXES = (("data",), ("data", "model"), ("pod", "data"), ("pod", "data", "model"))


def batch_axes(cfg: ModelConfig, mesh, parallel: ParallelConfig, B: int):
    """The mesh axes a global batch of ``B`` is cut over: ``("data",)``,
    ``("data", "model")`` (``sharding_mode="fsdp"``), each with ``"pod"``
    first where the mesh has the axis and it divides the batch, or None
    where the mesh does not divide it (every rank then computes every
    row)."""
    bax = batch_axes_for(B, build_rules(cfg, mesh, parallel), mesh_shape_dict(mesh))
    return bax if bax in BATCH_AXES else None


def default_accum(cfg: ModelConfig, shape: ShapeConfig, mesh,
                  parallel: Optional[ParallelConfig] = None) -> int:
    """The JAX package's choice of gradient-accumulation micro-batches: so
    a device's layer-input checkpoints stay within ~2.5 GB (a copy of
    ``repro.launch.steps.default_accum``; its 16 GB budget is the TPU's
    HBM, kept so the port's dry run takes the reference's micro-batches)."""
    if shape.kind != "train":
        return 1
    nds = n_dp_shards(mesh)
    if parallel is not None and parallel.sharding_mode == "fsdp":
        nds *= mesh_shape_dict(mesh).get("model", 1)
    n_dev = math.prod(mesh_shape_dict(mesh).values())
    B = shape.global_batch
    b_loc = max(B // nds, 1)
    tokens_dev = b_loc * shape.seq_len
    ckpt_bytes = tokens_dev * cfg.d_model * 2 * cfg.n_layers
    state_bytes = count_params(cfg) * 14 // n_dev  # bf16 p + f32 g,m,v
    # halve the nominal budget: transient (non-checkpoint) buffers in the
    # layer backward roughly match the checkpoint footprint
    budget = max(int((16e9 - state_bytes - 6e9) // 2), int(1_200_000_000))
    need = max(1, -(-ckpt_bytes // budget))
    accum = 1
    for cand in range(1, b_loc + 1):
        if b_loc % cand == 0:
            accum = cand
            if cand >= need:
                break
    return accum


def model_cuts(cfg: ModelConfig, mesh, parallel: ParallelConfig) -> frozenset:
    """The logical dims ``cfg``'s layers cut over a ``model`` axis above 1
    (``launch/state.py:shard_layout``): the rules' cuts where the axis
    divides the head counts, ``d_ff``, the padded vocab, the experts and
    the SSM heads.  Query heads the axis does not divide keep the
    attention whole on every rank (GSPMD splits the fused head dim); KV
    heads it does not divide keep ``wk``/``wv`` whole; SSM heads it does
    not divide keep the mixer whole."""
    M = mesh.sizes[1]
    if M == 1:
        return frozenset()
    rules = build_rules(cfg, mesh, parallel)
    heads = rules.heads == "model" and cfg.n_heads % M == 0
    cut = {"heads": heads,
           "kv_heads": heads and rules.kv_heads == "model" and cfg.n_kv_heads % M == 0,
           "mlp": rules.mlp == "model" and cfg.d_ff > 0 and cfg.d_ff % M == 0,
           "vocab": rules.vocab == "model" and cfg.padded_vocab % M == 0,
           "expert": (cfg.moe is not None and rules.expert == "model"
                      and cfg.moe.n_experts % M == 0),
           "ssm_inner": (cfg.ssm is not None and rules.ssm_inner == "model"
                         and (cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim) % M == 0)}
    return frozenset(n for n, on in cut.items() if on)


def model_axis(cfg: ModelConfig, mesh, parallel: ParallelConfig, shape: ShapeConfig
               ) -> Optional[ModelAxis]:
    """The step's :class:`ModelAxis` (None at a model axis of 1): the cuts
    of :func:`model_cuts`, sequence parallelism where the axis divides the
    sequence, and the experts run ``"a2a"`` where the model ranks hold
    different rows, ``"gather"`` where they hold the same."""
    if mesh.sizes[1] == 1:
        return None
    cuts = model_cuts(cfg, mesh, parallel)
    bax = batch_axes(cfg, mesh, parallel, shape.global_batch) or ()
    return ModelAxis(
        mesh.model_comm,
        sp=(parallel.sequence_parallel and parallel.sharding_mode == "tp_fsdp"
            and shape.seq_len % mesh.sizes[1] == 0),
        heads="heads" in cuts, kv="kv_heads" in cuts, mlp="mlp" in cuts, vocab="vocab" in cuts,
        expert=("a2a" if "model" in bax else "gather") if "expert" in cuts else None,
        ssm="ssm_inner" in cuts)


def mesh_layout(cfg: ModelConfig, mesh, parallel: Optional[ParallelConfig] = None
                ) -> ShardLayout:
    """Where ``mesh``'s ranks cut ``cfg``'s params."""
    parallel = parallel or ParallelConfig()
    parallel.check(mesh_shape_dict(mesh), cfg)
    return shard_layout(cfg, build_rules(cfg, mesh, parallel), mesh, parallel.fsdp,
                        model_cuts(cfg, mesh, parallel))


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

    ``mesh`` (``launch/mesh.py``) runs the step over the mesh on its
    device (``device`` is then unused; ``parallel`` defaults to
    ``ParallelConfig()``, FSDP on, as the JAX package's): ``state`` holds
    this rank's slices (``launch/state.py:to_local``: over ``model`` where
    the layers cut a leaf, over ``data`` under FSDP), ``batch`` and ``ndb``
    the global batch and masks.  The step carries ``layout`` (the
    :class:`ShardLayout`), ``rows`` (this rank's rows), ``accum`` and
    ``model_axis`` (its ``ModelAxis``, None at a model axis of 1).
    """
    if ndb_mode not in NDB_MODES:
        raise ValueError(f"ndb_mode {ndb_mode!r} not in {NDB_MODES}")
    B = shape.global_batch
    flags = flags or ExecFlags()
    layout = rows = bax = tp = None
    nds, sharded = 1, False
    if mesh is None:
        dev = resolve_device(device)
    else:
        parallel = parallel or ParallelConfig()
        layout = mesh_layout(cfg, mesh, parallel)
        tp = model_axis(cfg, mesh, parallel, shape)
        dev = mesh.device
        nds = n_dp_shards(mesh) * (mesh.sizes[1] if parallel.sharding_mode == "fsdp" else 1)
        bax = batch_axes(cfg, mesh, parallel, B)
        rows = rows_of(B, bax, mesh)
        sharded = bax is not None  # the ranks' shares combine in the forward and backward
        n_shards = B // (rows.stop - rows.start)
        # a rank's rows route in its share of the groups; a whole batch in all
        flags = dataclasses.replace(flags, n_dp_shards=max(nds // n_shards, 1))
        batch_comm = None if bax is None else mesh.comm_of(bax)
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

    def over_of(k: int) -> tuple:
        """The batch's groups in a pod that leaf ``k``'s gradient shares sum
        over: all but ``model`` where the leaf cuts that axis (its experts'
        exchange already summed the model ranks' rows)."""
        return tuple(a for a in bax if a != "pod" and (a != "model" or layout.mdims[k] is None))

    def in_pod(g, k: int, d: int, leaf: int, sync: Optional[StepSync]):
        """An FSDP leaf's gathered gradient share ``g`` (whole along ``d``)
        as this rank's slice of its pod's sum, in the backward
        (``parallel/fsdp.py``): reduce-scattered over its FSDP group where
        that is the batch's group in the pod, else all-reduced and cut;
        only cut where the backward already reduced the leaf
        (``sync.reduced``) or every rank computed the whole batch."""
        if not sharded or leaf in sync.reduced:
            return layout.cut_fsdp(g, k, dim=d)
        over = over_of(k)
        comm, tag = mesh.comm_of(over), "grad:" + layout.paths[k]
        if layout.groups[k] == over:
            return comm.reduce_scatter(g, d, tag=tag)
        return layout.cut_fsdp(comm.all_reduce(g, tag=tag), k, dim=d)

    def reduce_grads(grads: Tree, sync: Optional[StepSync]) -> Tree:
        """A rank's gradients, after the backward, as this rank's slices of
        the global gradient: a leaf FSDP leaves whole summed over the
        batch's groups in its pod (:func:`over_of`, the FSDP leaves were in
        the backward), then every leaf over ``pod`` where the batch is cut
        over it (a leaf is whole across the pods), once a leaf.  A leaf the
        backward already reduced (or every leaf, when each rank computed the
        whole batch) is left as it is."""
        synced = sync.synced if sharded else [True] * len(layout.dims)

        def one(g, k, done):
            if done:
                return g
            tag = "grad:" + layout.paths[k]
            if layout.dims[k] is None:
                g = mesh.comm_of(over_of(k)).all_reduce(g, tag=tag)
            return mesh.comm_of(("pod",)).all_reduce(g, tag=tag) if "pod" in bax else g

        leaves = tree_leaves(grads)
        out = [one(g, k, done) for k, (g, done) in enumerate(zip(leaves, synced))]
        by_id = dict(zip(map(id, leaves), out))
        return tree_map(lambda g: by_id[id(g)], grads)

    def local_grads(state: TrainState, batch: Dict, ctx: NDBContext, proj):
        """(metrics, this rank's slices of the global gradient) under the
        mesh."""
        batch = {k: v[rows] for k, v in batch.items()}
        if ctx.keep is not None:
            ctx = dataclasses.replace(ctx, keep=ctx.keep[:, rows],
                                      example_weight=ctx.example_weight[rows])
        sync = None
        if sharded or tp is not None:
            both = None if bax is None else mesh.comm_of(bax + ("model",))
            experts = (mesh.comm_of(tuple(a for a in bax if a != "model"))
                       if tp is not None and tp.expert == "a2a" else batch_comm)
            sync = StepSync(batch_comm, layout.paths, tp, both, experts)
        fsdp = (LayerGather(layout, lambda g, k, d, leaf: in_pod(g, k, d, leaf, sync))
                if layout.fsdp_sharded else None)
        params = state.params
        if accum == 1:
            _loss, metrics, grads = loss_and_grads(params, proj, batch, cfg, ctx, flags, sync,
                                                   fsdp)
            grads = reduce_grads(grads, sync)
        else:
            _loss, metrics, grads = accumulated_loss_and_grads(
                params, proj, batch, cfg, ctx, flags, accum, compress,
                reduce=lambda g: reduce_grads(g, sync), sync=sync, fsdp=fsdp)
        if sharded:  # the shares' sums: the global batch's metrics
            metrics = {k: batch_comm.all_reduce(v.detach().clone().reshape(1),
                                                tag="metrics")[0] for k, v in metrics.items()}
        return metrics, grads

    def counted() -> list:
        """Per leaf, what of this rank's slice counts in the global norm:
        all of it on coordinate 0 of every axis that does not cut the leaf
        (``pod`` cuts none), else nothing; a segmented leaf's whole pieces
        on model rank 0 only (``ShardLayout.own``)."""
        d0, m0 = mesh.coords

        def one(k):
            cuts_model = layout.mdims[k] is not None or layout.groups[k] == ("data", "model")
            if mesh.pod_coord or not ((cuts_model or m0 == 0)
                                      and (layout.dims[k] is not None or d0 == 0)):
                return False
            return True if layout.seg(k) is None else (lambda x: layout.own(x, k))

        return [one(k) for k in range(len(layout.dims))]

    def step(state: TrainState, batch: Dict, ndb: Optional[Dict] = None):
        with span("train.step"):
            return one_step(state, batch, ndb)

    def one_step(state: TrainState, batch: Dict, ndb: Optional[Dict]):
        if ndb is not None and ndb_mode != "dynamic":
            raise ValueError(f"a {ndb_mode!r} step takes step(state, batch)")
        with span("train.h2d"):
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
        with span("train.clip"):
            if layout is not None and layout.sharded:  # each distinct slice counts once
                grads, gnorm = clip_by_global_norm(grads, train.grad_clip, mesh.world_comm,
                                                   counted())
            else:
                grads, gnorm = clip_by_global_norm(grads, train.grad_clip)
        with span("train.optimizer"):
            lr = schedule(state.step)
            params, opt = apply_update(state.params, grads, state.opt, lr, state.step, train)
        new_state = TrainState(step=state.step + 1, params=params, opt=opt, proj=state.proj)
        return new_state, dict(metrics, grad_norm=gnorm, lr=lr)

    step.layout, step.rows, step.accum, step.model_axis = layout, rows, accum, tp
    return step


# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------

# the mesh of one process, where a serve step is built without one
_ONE = SimpleNamespace(axis_names=AXES, shape={"data": 1, "model": 1}, sizes=(1, 1))


def serve_flags(parallel: ParallelConfig, mesh, flags: Optional[ExecFlags] = None) -> ExecFlags:
    """``build_flags``' counterpart for the serve steps: ``remat="none"``
    and the JAX package's ``n_dp_shards`` (D, or D·M under
    ``sharding_mode="fsdp"``), the MoE routing groups of the global
    batch."""
    nds = 1
    if mesh is not None:
        nds = n_dp_shards(mesh) * (mesh.sizes[1] if parallel.sharding_mode == "fsdp" else 1)
    flags = flags or ExecFlags(n_dp_shards=nds)
    return dataclasses.replace(flags, remat="none")


class _ServePlan:
    """What a prefill or decode step of ``cfg`` does on ``mesh`` (None: one
    process): the rules, this rank's rows, its ``ModelAxis`` (no sequence
    parallelism in a decode), the params' layout and, where FSDP cuts a
    leaf, the gather (``fsdp``) that the forward reads the params through,
    a layer at a time."""

    def __init__(self, cfg, parallel, mesh, shape, flags, decode: bool):
        parallel = parallel or ParallelConfig()
        self.B = shape.global_batch
        self.flags = serve_flags(parallel, mesh, flags)
        one = mesh is None or math.prod(mesh_shape_dict(mesh).values()) == 1
        self.rules = build_rules(cfg, mesh or _ONE, parallel)
        self.bax = batch_axes_for(self.B, self.rules, mesh_shape_dict(mesh or _ONE))
        self.layout = self.tp = self.fsdp = None
        self.rows = slice(0, self.B)
        if not one:
            self.layout = mesh_layout(cfg, mesh, parallel)
            if self.layout.fsdp_sharded:
                self.fsdp = LayerGather(self.layout)
            tp = model_axis(cfg, mesh, parallel, shape)
            self.tp = dataclasses.replace(tp, sp=False) if tp is not None and decode else tp
            self.rows = rows_of(self.B, batch_axes(cfg, mesh, parallel, self.B), mesh)
            n_shards = self.B // (self.rows.stop - self.rows.start)
            # a rank's rows route in its share of the groups; a whole batch in all
            self.flags = dataclasses.replace(
                self.flags, n_dp_shards=max(self.flags.n_dp_shards // n_shards, 1))
        self.kv_heads = held_kv_heads(cfg, self.tp)
        self.ssm_heads = held_ssm_heads(cfg, self.tp)

    @property
    def n_rows(self) -> int:
        return self.rows.stop - self.rows.start

    def specs(self, cfg: ModelConfig, shape: ShapeConfig, max_len: int) -> Dict[str, Any]:
        """The params', inputs', caches' and logits' specs (the JAX rules'),
        and ``held_caches``: the caches' specs as a rank holds them."""
        msd = mesh_shape_dict(getattr(self.layout, "mesh", _ONE))
        dshape = ShapeConfig(shape.name, max_len, self.B, "decode")
        _, dspecs = input_specs(cfg, dshape, self.rules, msd)
        kv_cut = self.tp is not None and self.tp.kv
        ssm_cut = self.tp is not None and self.tp.ssm
        held = tuple({k: held_cache_spec(a, self.bax, self.rules, kv_cut, ssm_cut)
                      for k, a in e.items()} for e in cache_annotations(cfg))
        out = {"params": spec_tree(self.rules, param_annotations(cfg)),
               "caches": dspecs["caches"], "held_caches": held,
               "logits": Spec(self.bax, self.rules.vocab)}
        if shape.kind == "decode":
            out["inputs"] = dspecs
        else:
            out["batch"] = input_specs(cfg, shape, self.rules, msd)[1]
        return out

    def attach(self, step):
        step.layout, step.rows, step.model_axis, step.flags = (
            self.layout, self.rows, self.tp, self.flags)
        return step


def make_prefill_step(cfg: ModelConfig, parallel: Optional[ParallelConfig], mesh,
                      shape: ShapeConfig, *, flags: Optional[ExecFlags] = None,
                      max_len: Optional[int] = None):
    """Returns ``(step, specs)``, ``step(params, batch) -> (caches,
    logits)``: the prompt prefill of ``forward_prefill`` on ``shape``'s
    (B, S) (the trunk's sequence, a vision stub's patches included) into
    caches of ``max_len`` (default S) positions.

    ``mesh`` None, or a 1×1 mesh, is ``forward_prefill`` itself on the
    params' device.  Over a (data, model) mesh ``params`` are this rank's
    slices (``launch/state.py:local_params``, ``init_params(...,
    layout=step.layout)`` or ``params_from_numpy(..., layout=)``) and
    ``batch`` is the global batch; the step runs this rank's rows
    (``step.rows``) with the model axis of the train step (tensor
    parallelism over heads, FFN and vocab, the experts' ``"gather"`` or
    ``"a2a"``, sequence parallelism where ``shape.seq_len`` splits),
    gathering each layer's FSDP dims where the layer reads them
    (``parallel/fsdp.py``).  It returns this rank's caches (its
    rows, its KV heads, its SSM heads and conv channels:
    ``specs["held_caches"]``) and logits (its rows,
    its vocabulary columns where the axis cuts the vocabulary), under
    ``torch.no_grad()``.  ``specs`` holds the JAX rules' specs of the
    params, the batch, the caches and the logits (``Spec(bax, vocab)``).
    """
    plan = _ServePlan(cfg, parallel, mesh, shape, flags, decode=False)
    B, S = shape.global_batch, shape.seq_len
    L = max_len or S

    def step(params: Tree, batch: Dict):
        batch = to_device(batch, params["embed"].device)
        if trunk_shape(batch) != (B, S):
            raise ValueError(f"trunk sequence {trunk_shape(batch)}, want {(B, S)} ({shape.name})")
        if plan.n_rows != B:
            batch = {k: v[plan.rows] for k, v in batch.items()}
        with torch.no_grad():
            structs = cache_structs(cfg, plan.n_rows, L, kv_heads=plan.kv_heads,
                                    ssm_heads=plan.ssm_heads)
            return forward_prefill(params, batch, cfg, structs, flags=plan.flags, tp=plan.tp,
                                   fsdp=plan.fsdp)

    return plan.attach(step), plan.specs(cfg, shape, L)


def make_decode_step(cfg: ModelConfig, parallel: Optional[ParallelConfig], mesh,
                     shape: ShapeConfig, *, flags: Optional[ExecFlags] = None):
    """Returns ``(step, specs)``, ``step(params, caches, token, cur_len) ->
    (caches, logits)``: one ``forward_decode`` step of ``shape``'s batch
    over dense caches of ``shape.seq_len`` positions, written in place.

    ``mesh`` as in :func:`make_prefill_step`, without sequence
    parallelism: ``caches`` are this rank's (a prefill step's), ``token``
    the global (B,) ids or this rank's rows of them (what ``greedy_token``
    gives on its logits under the model axis), ``cur_len`` a scalar.
    ``specs["inputs"]`` holds the JAX rules' specs of ``token``,
    ``cur_len`` and ``caches``.
    """
    plan = _ServePlan(cfg, parallel, mesh, shape, flags, decode=True)
    B = shape.global_batch

    def step(params: Tree, caches, token, cur_len):
        dev = params["embed"].device
        token = torch.as_tensor(np.asarray(token) if not torch.is_tensor(token) else token,
                                device=dev)
        if token.shape[0] == B and plan.n_rows != B:
            token = token[plan.rows]
        with torch.no_grad():
            return forward_decode(params, caches, token, cur_len, cfg, flags=plan.flags,
                                  tp=plan.tp, fsdp=plan.fsdp)

    return plan.attach(step), plan.specs(cfg, shape, shape.seq_len)
