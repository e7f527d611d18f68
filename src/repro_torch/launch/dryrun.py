"""Dry run: one rank's real step of every (arch × shape × mesh) cell, with
no data (the counterpart of ``repro.launch.dryrun``).

For each cell this builds the port's real train, prefill or decode step
(``launch/steps.py``) on rank 0 of the production mesh's dry form
(``launch/mesh.py:make_production_mesh(..., dry=True)``: every group's
collectives count and move nothing), gives it this rank's state and
inputs as tensors of the meta device (``launch/state.py:state_structs``),
and runs it once under ``launch/cost.py:CostMode``.  Every kernel takes
its meta route (``kernels/__init__.py``): it makes its outputs and books
its own operations and bytes; a backward that recomputes a plain version
recomputes it on meta.  This is the port's counterpart of the reference's
``pallas`` substitution, always on, because the port always launches its
kernels on the card.  A decode step attends over a full cache
(``cur_len = seq_len - 1``), a count the host knows.

Each record holds the reference's roofline fields (``launch/roofline.py``)
and the port's own: ``peak_bytes_per_dev`` (the peak of live storages),
``gathered_peak_bytes_per_dev`` (the peak of the FSDP gathers' outputs
alive at once) beside ``gathered_bound_bytes_per_dev`` (two layers'
gathered leaves plus those outside the trunk, :func:`gather_bound`),
``state_bytes_per_dev`` (params, grads, moments and V1 held, or a decode's
params and caches), ``fits`` (the peak under the card's 80 GiB),
``launches`` by kernel and ``seconds`` (the dry step's wall time).  The
numbers are counts, not times: nothing here runs on a card.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
      [--mesh single|multi|both] [--ndb off|degraded|dynamic]
      [--out experiments/dryrun_torch] [--force] [--list] [--table]

``--table`` runs nothing: it prints the records found in ``--out`` as a
markdown table (state / peak / gathered GiB a rank and the three roofline
terms, on each mesh).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import math
import os
import sys
import time
from typing import Dict, Optional

import torch

from repro_torch.configs.base import (
    SHAPES, MeCeFOConfig, ModelConfig, ParallelConfig, ShapeConfig, TrainConfig, get_config,
    shape_applicable,
)
from repro_torch.launch.cost import Cost, CostMode, tensors_of
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.launch.roofline import RooflineReport, model_flops, summarize
from repro_torch.launch.specs import input_specs, ndb_specs
from repro_torch.launch.state import param_structs, state_structs
from repro_torch.launch.steps import (
    default_accum, make_decode_step, make_prefill_step, make_train_step, mesh_layout,
)
from repro_torch.models.kvcache import cache_structs, held_kv_heads, held_ssm_heads
from repro_torch.models.model import ExecFlags
from repro_torch.parallel.sharding import ShardingRules

_log = logging.getLogger("repro_torch.dryrun")

ASSIGNED = [
    "glm4-9b",
    "qwen3-0.6b",
    "granite-34b",
    "nemotron-4-340b",
    "musicgen-medium",
    "mamba2-2.7b",
    "jamba-1.5-large-398b",
    "qwen3-moe-30b-a3b",
    "qwen3-moe-235b-a22b",
    "phi-3-vision-4.2b",
]

# the card's device memory: H100 SXM, 80 GiB
HBM_BYTES = 80 * 2 ** 30


@dataclasses.dataclass
class DryStep:
    """One rank's dry step: its counts and what it holds."""

    cost: Cost
    state_bytes: Dict[str, int]  # held at the step's end, by part
    seconds: float
    accum: int = 1

    @property
    def state_bytes_per_dev(self) -> int:
        return sum(self.state_bytes.values())


def nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tensors_of(tree))


def mecefo_for(ndb: str, lowrank_sync: bool = False) -> MeCeFOConfig:
    """The reference's MeCeFO config of a dry run's ``ndb`` mode."""
    mode = "off" if ndb == "off" else ("static" if ndb == "degraded" else "dynamic")
    return MeCeFOConfig(mode=mode, lowrank_sync=lowrank_sync)


def zero_inputs(cfg: ModelConfig, shape: ShapeConfig, device) -> dict:
    """The global train or prefill batch as zeros (shapes only on meta)."""
    shapes, _ = input_specs(cfg, shape, ShardingRules(), {})
    return {k: torch.zeros(s, dtype=dt, device=device) for k, (s, dt) in shapes.items()}


def dry_step(cfg: ModelConfig, shape: ShapeConfig, mesh: Optional[Mesh] = None, *,
             ndb: str = "off", parallel: Optional[ParallelConfig] = None,
             mecefo: Optional[MeCeFOConfig] = None, train: Optional[TrainConfig] = None,
             flags: Optional[ExecFlags] = None, device="meta") -> DryStep:
    """Run one rank's step of ``shape`` once under :class:`CostMode`, on
    ``mesh`` (its device) or on one process on ``device`` (the meta device
    by default), with this rank's state and the global inputs made there as
    zeros (the NDB masks as ones): on the meta device shapes only, on a
    real one a step whose counts are the meta run's.  ``ndb`` is the step's NDB mode (``"off"``,
    ``"degraded"``, ``"dynamic"``; ``"static"`` takes ``"degraded"``'s
    masks-free program), ``mecefo`` defaults to the reference's
    (:func:`mecefo_for`), ``flags`` to ``remat=parallel.remat``."""
    parallel = parallel or ParallelConfig()
    train = train or TrainConfig()
    mecefo = mecefo or mecefo_for(ndb)
    dev = mesh.device if mesh is not None else torch.device(device)
    t0 = time.perf_counter()
    if shape.kind == "train":
        flags = flags or ExecFlags(remat=parallel.remat)
        step = make_train_step(cfg, train, mecefo, shape, ndb_mode=ndb, flags=flags,
                               device=dev, parallel=parallel, mesh=mesh)
        state = state_structs(cfg, train, mecefo, step.layout, dev)
        args = [state, zero_inputs(cfg, shape, dev)]
        if ndb == "dynamic":
            shapes, _ = ndb_specs(cfg, shape.global_batch, None)
            args.append({k: torch.ones(s, dtype=dt, device=dev) for k, (s, dt) in shapes.items()})
        with CostMode(args) as mode:
            state, _metrics = step(*args)
        held = {"params": nbytes(state.params), "grads": nbytes(state.params),
                "moments": nbytes(state.opt), "v1": nbytes(state.proj)}
        return DryStep(mode.cost, held, time.perf_counter() - t0, step.accum)
    if shape.kind == "prefill":
        step, _ = make_prefill_step(cfg, parallel, mesh, shape, flags=flags)
        params = param_structs(cfg, step.layout, dev)
        args = (params, zero_inputs(cfg, shape, dev))
        with CostMode(args) as mode:
            caches, _logits = step(*args)
        held = {"params": nbytes(params), "caches": nbytes(caches)}
        return DryStep(mode.cost, held, time.perf_counter() - t0)
    step, _ = make_decode_step(cfg, parallel, mesh, shape, flags=flags)
    params = param_structs(cfg, step.layout, dev)
    n = step.rows.stop - step.rows.start
    caches = tuple({k: torch.zeros(c.shape, dtype=c.dtype, device=dev) for k, c in e.items()}
                   for e in cache_structs(cfg, n, shape.seq_len,
                                          kv_heads=held_kv_heads(cfg, step.model_axis),
                                          ssm_heads=held_ssm_heads(cfg, step.model_axis)))
    token = torch.zeros(shape.global_batch, dtype=torch.int32, device=dev)
    with CostMode((params, caches, token)) as mode:
        caches, _logits = step(params, caches, token, shape.seq_len - 1)
    held = {"params": nbytes(params), "caches": nbytes(caches)}
    return DryStep(mode.cost, held, time.perf_counter() - t0)


def gather_bound(cfg: ModelConfig, layout) -> int:
    """Two layers' gathered leaves (a layer: one position's mixer and FFN,
    the largest) plus the gathered leaves outside the trunk, in bytes: the
    most a step that gathers a layer at a time may hold gathered at once."""
    el = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    layer: Dict[str, int] = {}
    outside = 0
    for k, path in enumerate(layout.paths):
        if layout.dims[k] is None:
            continue
        n = math.prod(layout.local_shape(k)) * layout.mesh.size_of(layout.groups[k]) * el
        if path.startswith("layers."):
            pos = path.split(".")[1]
            layer[pos] = layer.get(pos, 0) + n // layout.shapes[k][0]
        else:
            outside += n
    return 2 * max(layer.values(), default=0) + outside


def report(arch: str, shape: ShapeConfig, mesh_name: str, n_devices: int, cfg: ModelConfig,
           got: DryStep, extras: dict) -> RooflineReport:
    """The roofline record of a dry step (the module docstring)."""
    c = got.cost

    def by(table):
        out = {}
        for key in table.values():
            for k, e in key.items():
                out[k] = out.get(k, 0) + e["bytes"]
        return out

    kinds = {kind: sum(e["bytes"] for e in tags.values()) for kind, tags in c.collectives.items()}
    return RooflineReport(
        arch=arch, shape=shape.name, mesh=mesh_name, n_devices=n_devices,
        flops_per_dev=c.flops, bytes_per_dev=float(c.bytes),
        collective_bytes_per_dev=float(c.collective_bytes), collectives=kinds,
        model_flops_global=model_flops(cfg, shape), bytes_per_dev_peak=float(c.peak_bytes),
        seconds=got.seconds, collectives_by_group=by(c.collectives_by_group),
        extras={**extras, "peak_bytes_per_dev": c.peak_bytes,
                "state_bytes_per_dev": got.state_bytes_per_dev, "state_bytes": got.state_bytes,
                "fits": c.peak_bytes < HBM_BYTES, "launches": c.launches,
                "gathered_peak_bytes_per_dev": c.gathered_peak_bytes,
                "kernel_flops_per_dev": c.kernel_flops, "kernel_bytes_per_dev": c.kernel_bytes,
                "kernel_work": c.kernel_work, "collectives_by_tag": c.collectives,
                "collectives_by_group_kind": c.collectives_by_group, "n_ops": c.n_ops,
                "start_bytes_per_dev": c.start_bytes, "accum": got.accum})


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    ndb: str = "off",
    parallel: Optional[ParallelConfig] = None,
    out_dir: str = "experiments/dryrun_torch",
    force: bool = False,
    verbose: bool = True,
    variant: str = "",
    causal_slice: bool = False,
    pallas: bool = False,
    sharding_mode: str = "tp_fsdp",
    accum: int = 0,
    remat: str = "",
    sequence_parallel: bool = False,
    bf16_grad_reduce: bool = False,
    lowrank_sync: bool = False,
):
    """Dry-run one cell on rank 0 of the production mesh; returns its
    record (a dict), or the reference's skip record, written to
    ``out_dir`` under the reference's file name (a cached one is returned
    unless ``force``).  ``pallas`` and ``causal_slice`` are XLA's and
    raise."""
    if pallas:
        raise NotImplementedError(
            "pallas: the port's dry run always books its hand-written kernels (their meta "
            "route), the counterpart of the reference's Pallas substitution")
    if causal_slice:
        raise NotImplementedError(
            "causal_slice: an XLA lowering of the reference's chunked attention; the port's "
            "causal attention is kernel #2, whose count already covers only the causal pairs")
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    tag = f"{arch}__{shape_name}__{mesh_name}" + (f"__{ndb}" if ndb != "off" else "")
    if variant:
        tag += f"__{variant}"
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            cached = json.load(f)
        if verbose:
            _log.info("[cached] %s", tag)
        return cached

    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "skipped": reason}
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=2)
        if verbose:
            _log.info("[skip]   %s: %s", tag, reason)
        return rec

    parallel = parallel or ParallelConfig()
    if sharding_mode != "tp_fsdp":
        parallel = dataclasses.replace(parallel, sharding_mode=sharding_mode)
    if remat:
        parallel = dataclasses.replace(parallel, remat=remat)
    if sequence_parallel:
        parallel = dataclasses.replace(parallel, sequence_parallel=True)
    if bf16_grad_reduce:
        parallel = dataclasses.replace(parallel, grad_compression="bf16")
    if accum:
        parallel = dataclasses.replace(parallel, accum=accum)
    mesh = make_production_mesh(multi_pod, dry=True)
    if shape.kind == "train" and parallel.accum == 1:
        parallel = dataclasses.replace(parallel, accum=default_accum(cfg, shape, mesh, parallel))
    got = dry_step(cfg, shape, mesh, ndb=ndb, parallel=parallel,
                   mecefo=mecefo_for(ndb, lowrank_sync))
    rep = report(arch, shape, mesh_name, mesh.size, cfg, got, {
        "gathered_bound_bytes_per_dev": gather_bound(cfg, mesh_layout(cfg, mesh, parallel)),
        "ndb": ndb, "variant": variant or "baseline", "sharding_mode": parallel.sharding_mode,
        "remat": parallel.remat, "sequence_parallel": parallel.sequence_parallel,
        "grad_compression": parallel.grad_compression, "lowrank_sync": lowrank_sync})
    rec = rep.to_dict()
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=2)
    if verbose:
        _log.info("[ok %6.1fs] %s", got.seconds, summarize(rep))
        _log.info("           state %.2f GiB, peak %.2f GiB a rank (gathered %.2f of %.2f)%s",
                  rec["state_bytes_per_dev"] / 2 ** 30, rec["peak_bytes_per_dev"] / 2 ** 30,
                  rec["gathered_peak_bytes_per_dev"] / 2 ** 30,
                  rec["gathered_bound_bytes_per_dev"] / 2 ** 30,
                  "" if rec["fits"] else " (does not fit)")
    return rec


def table(out_dir: str, archs, shapes) -> str:
    """The records of ``out_dir`` as a markdown table, a row a cell, and
    how many records keep their gathered peak within their bound."""
    gib = 2 ** 30
    n = within = 0
    rows = ["| arch | shape | state / peak / gathered GiB a rank, 16×16 | 2×16×16 | fits "
            "| compute / memory / collective ms, 16×16 | 2×16×16 | bottleneck |",
            "| --- | --- | --- | --- | --- | --- | --- | --- |"]
    for a in archs:
        for s in shapes:
            recs = []
            for m in ("single", "multi"):
                path = os.path.join(out_dir, f"{a}__{s}__{m}.json")
                if os.path.exists(path):
                    with open(path) as f:
                        recs.append(json.load(f))
            recs = [r for r in recs if "skipped" not in r]
            if not recs:
                continue
            n += len(recs)
            within += sum(r["gathered_peak_bytes_per_dev"] <= r["gathered_bound_bytes_per_dev"]
                          for r in recs)
            mem = [f"{r['state_bytes_per_dev'] / gib:.2f} / {r['peak_bytes_per_dev'] / gib:.2f}"
                   f" / {r['gathered_peak_bytes_per_dev'] / gib:.2f}" for r in recs]
            terms = [" / ".join(f"{1e3 * r[t]:.1f}" for t in ("t_compute", "t_memory",
                                                              "t_collective")) for r in recs]
            fits = "/".join("yes" if r["fits"] else "**no**" for r in recs)
            neck = " / ".join(dict.fromkeys(r["bottleneck"] for r in recs))
            rows.append(f"| {a} | {s} | {' | '.join(mem)} | {fits} | {' | '.join(terms)} "
                        f"| {neck} |")
    rows.append(f"\ngathered peak within its bound: {within} of {n} records")
    return "\n".join(rows) + "\n"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch (default: all assigned)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--ndb", default="off", choices=["off", "degraded", "dynamic"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--table", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch import obs

    obs.logging_setup()

    archs = [args.arch] if args.arch else ASSIGNED
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    if args.list:
        for a in archs:
            for s in shapes:
                sys.stdout.write(f"{a} {s}\n")
        return
    if args.table:
        sys.stdout.write(table(args.out, archs, shapes))
        return
    failures = []
    t0 = time.perf_counter()
    for a in archs:
        for s in shapes:
            for mp in meshes:
                try:
                    run_cell(a, s, mp, ndb=args.ndb, out_dir=args.out, force=args.force)
                except Exception:  # noqa: BLE001 - report and continue
                    failures.append((a, s, mp))
                    _log.exception("[FAIL] %s %s %s", a, s, "multi" if mp else "single")
    if failures:
        _log.error("%d FAILURES", len(failures))
        raise SystemExit(1)
    _log.info("all cells ran OK in %.1f s", time.perf_counter() - t0)


if __name__ == "__main__":
    main()
