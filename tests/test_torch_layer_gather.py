"""The FSDP gather a layer at a time (``parallel/fsdp.py``) in the mesh
train, prefill and decode steps, on the CPU.

* **Gather bound.**  On the production meshes' dry form (16×16 and
  2×16×16) at the published widths of nemotron-4-340b and
  jamba-1.5-large-398b, cut to 2 periods and 1 micro-batch, the FSDP
  gathers' outputs alive at once (``gathered_peak_bytes``) stay within
  two layers' gathered leaves (a layer: one position's mixer and FFN)
  plus the leaves outside the trunk, for a train step in ``off`` and
  ``degraded`` (with ``lowrank_sync``) under each remat (jamba's meta step
  takes seconds: ``none``, ``ffn`` and ``full`` in ``degraded`` on 16×16,
  ``full`` also on 2×16×16; the pods cut no leaf), and for a prefill and a
  decode; a trunk
  leaf is gathered at most three times a period in a train step and once
  in a serve step.
* **Gloo parity.**  Four gloo ranks at (pod, data, model) = (2, 2, 1)
  train three steps against the live JAX step on the global batch at
  ``tests/test_torch_dist.py``'s tolerances: accumulation 2 with bf16
  compression, ``dynamic`` masks and ``lowrank_sync`` (and ``degraded``
  with ``lowrank_sync``, whose factored leaves the backward reduces), and
  ``dynamic`` under the remats ``none`` (every weight saved as a token)
  and ``full`` (a layer's checkpoint).  Every
  gradient slice is all-reduced over ``pod`` once a leaf a micro-batch.
* **Leaf identity.**  No leaf that ``degraded_sync`` marks as reduced in
  the backward is keyed ``"?"``: a gathered weight carries its leaf.
"""
import dataclasses
import math
import os
from collections import defaultdict

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402
from repro_torch.launch.dist import spawn  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models.model import ExecFlags  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from tests import test_torch_tp as tp  # noqa: E402
from tests.test_torch_dist import (  # noqa: E402
    ATOL, BF16_FLIP_SHARE, LR, PARAM_LOOSE_SHARE, PARAM_LR_FRAC, RTOL, _close, _np,
)

ARCHS = ("nemotron-4-340b", "jamba-1.5-large-398b")
MODES = [(remat, ndb) for remat in ("none", "ffn", "full", "dots") for ndb in ("off", "degraded")]
# jamba's meta step takes seconds: in ``degraded`` on 16×16 under the remats
# that gather differently (``"dots"`` checkpoints a layer as ``"full"``
# does), the default ("full") also on 2×16×16
TRAIN = ([("nemotron-4-340b", multi, *m) for multi in (False, True) for m in MODES]
         + [("jamba-1.5-large-398b", False, r, "degraded") for r in ("none", "ffn", "full")]
         + [("jamba-1.5-large-398b", True, "full", "degraded")])


def two_periods(arch: str) -> tbase.ModelConfig:
    cfg = tbase.get_config(arch)
    return dataclasses.replace(cfg, n_layers=2 * cfg.block_period)


def gather_bound(layout, cfg) -> tuple:
    """(two layers' gathered leaves plus the leaves outside the trunk, in
    bytes, from the shapes; the trunk's gathered leaf paths)."""
    el = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    per_layer, outside, trunk = defaultdict(int), 0, []
    for k, path in enumerate(layout.paths):
        if layout.dims[k] is None:
            continue
        n = math.prod(layout.local_shape(k)) * layout.mesh.size_of(layout.groups[k]) * el
        if path.startswith("layers."):
            per_layer[path.split(".")[1]] += n // layout.shapes[k][0]
            trunk.append(path)
        else:
            outside += n
    bound = 2 * max(per_layer.values()) + outside
    assert bound == dryrun.gather_bound(cfg, layout)  # the records' bound
    return bound, trunk


def param_gathers(cost) -> dict:
    return {t[len("param:"):]: e["calls"] for t, e in cost.collectives.get("all_gather", {}).items()
            if t.startswith("param:")}


@pytest.mark.parametrize("arch,multi,remat,ndb", TRAIN)
def test_train_step_holds_at_most_two_gathered_layers(arch, multi, remat, ndb, monkeypatch):
    cfg = two_periods(arch)
    mesh = make_production_mesh(multi, dry=True)
    parallel = tbase.ParallelConfig(accum=1, remat=remat)
    got, reduced = recorded_step(monkeypatch, cfg, mesh, parallel, ndb, ExecFlags(remat=remat))
    layout = steps.mesh_layout(cfg, mesh, parallel)
    if ndb == "degraded":
        check_marked(reduced, layout)
    bound, trunk = gather_bound(layout, cfg)
    assert 0 < got.cost.gathered_peak_bytes <= bound, (got.cost.gathered_peak_bytes, bound)
    calls = param_gathers(got.cost)
    for path in trunk:  # the forward, a recompute, the backward: at most 3 a period
        assert calls.get(path, 0) <= 3 * 2, (path, calls.get(path))
    assert any(calls.get(path, 0) > 2 for path in trunk)  # the backward gathered again


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_serve_steps_gather_each_layer_once(arch, multi, shape):
    cfg = two_periods(arch)
    mesh = make_production_mesh(multi, dry=True)
    got = dryrun.dry_step(cfg, tbase.SHAPES[shape], mesh)
    bound, trunk = gather_bound(steps.mesh_layout(cfg, mesh, tbase.ParallelConfig()), cfg)
    assert 0 < got.cost.gathered_peak_bytes <= bound, (got.cost.gathered_peak_bytes, bound)
    calls = param_gathers(got.cost)
    assert all(calls[path] == 2 for path in trunk), calls  # once a period


class _Recorded(steps.StepSync):
    """A step sync that keeps itself, so a test can read what the backward
    marked."""

    made: list = []

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        _Recorded.made.append(self)


def recorded_step(monkeypatch, cfg, mesh, parallel, ndb, flags=None):
    """One dry train step on ``mesh`` (``lowrank_sync`` on) and the leaves
    its sync marked as reduced in the backward."""
    _Recorded.made = []
    monkeypatch.setattr(steps, "StepSync", _Recorded)
    got = dryrun.dry_step(cfg, tbase.SHAPES["train_4k"], mesh, ndb=ndb, parallel=parallel,
                          mecefo=dryrun.mecefo_for(ndb, lowrank_sync=True), flags=flags)
    assert len(_Recorded.made) == 1
    return got, _Recorded.made[0].reduced


def check_marked(reduced: dict, layout) -> None:
    """``degraded_sync`` marked low-rank leaves by their paths, some of
    them gathered ones."""
    assert reduced and "?" not in reduced.values(), reduced
    lowrank = {p for p in layout.paths if p.rsplit(".", 1)[-1] in (
        "w_up", "w_gate", "w_down", "in_proj", "out_proj")}
    assert set(reduced.values()) <= lowrank
    assert any(layout.dims[layout.paths.index(p)] is not None for p in reduced.values())


def test_degraded_sync_marks_gathered_experts_by_their_leaf(monkeypatch):
    cfg = two_periods("qwen3-moe-30b-a3b")
    mesh = make_production_mesh(False, dry=True)
    parallel = tbase.ParallelConfig(accum=1)
    _got, reduced = recorded_step(monkeypatch, cfg, mesh, parallel, "degraded")
    check_marked(reduced, steps.mesh_layout(cfg, mesh, parallel))
    assert any(".ffn.w_" in p for p in reduced.values())


# ---------------------------------------------------------------------------
# gloo ranks at (pod, data, model) = (2, 2, 1) against the JAX step
# ---------------------------------------------------------------------------

P, D = 2, 2
CASES = [
    dict(tp.case("accum-bf16-sync", mode="dynamic", sync=True, accum=2, compress="bf16"),
         remat="ffn"),
    dict(tp.case("degraded-accum-bf16-sync", mode="degraded", sync=True, accum=2,
                 compress="bf16"), remat="ffn"),
] + [dict(tp.case(f"remat-{r}", mode="dynamic"), remat=r) for r in ("none", "full")]


def lg_ranks(mesh, cases, init_path, out_dir):
    """One rank: each case's three steps from the JAX initial state (as
    ``tests/test_torch_tp.py:tp_ranks``, with the case's remat), its
    collectives by group and the leaves its syncs marked."""
    from repro_torch.core.ndb import plan_to_masks
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.state import gather_state, to_local
    from repro_torch.parallel import collectives

    made = []

    class Recorded(steps.StepSync):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)

    steps.StepSync = Recorded
    torch.set_num_threads(1)  # four ranks beside the other test workers
    init = torch.load(init_path, weights_only=False)["dense"]
    cfg = tp._cfg(tbase, "dense")
    for c in cases:
        src = SyntheticLM(cfg.vocab_size)
        keep, w = plan_to_masks(tp.PLANS[tp.B], cfg, tp.B)
        step = steps.make_train_step(
            cfg, tbase.TrainConfig(learning_rate=LR),
            tbase.MeCeFOConfig(mode="dynamic", rank=tp.RANK, lowrank_sync=c["sync"]),
            tbase.ShapeConfig("t", tp.S, tp.B, "train"), ndb_mode=c["mode"], total_steps=10,
            flags=ExecFlags(remat=c["remat"], ce_chunk=16), mesh=mesh,
            parallel=tbase.ParallelConfig(fsdp=True, accum=c["accum"],
                                          grad_compression=c["compress"]))
        st = to_local(init._replace(params=tp._clone(init.params),
                                    opt=type(init.opt)(*map(tp._clone, init.opt)),
                                    proj=tp._clone(init.proj)), step.layout)
        collectives.reset_counts()
        made.clear()
        metrics = []
        for i in range(tp.STEPS):
            extra = ({"keep": keep, "example_weight": w},) if c["mode"] == "dynamic" else ()
            st, m = step(st, src.batch(i, tp.B, tp.S), *extra)
            metrics.append({k: float(v) for k, v in m.items()})
        lay = step.layout
        whole = gather_state(st, lay)
        torch.save({"metrics": metrics, "counts": collectives.counts(),
                    "groups": collectives.group_counts(), "local": st.params,
                    "dims": lay.dims, "paths": lay.paths, "accum": step.accum,
                    "marked": [set(s.reduced.values()) for s in made],
                    "whole": whole if mesh.rank == 0 else None},
                   os.path.join(out_dir, f"{c['name']}.{mesh.rank}.pt"))


@pytest.fixture(scope="module")
def pod_ranks_out(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("layer_gather")
    init = tp.init_file(tmp, ["dense"])
    spawn(lg_ranks, P * D, CASES, init, str(tmp), pod=P, device="cpu", timeout=600)
    return tmp


@pytest.mark.parametrize("c", CASES, ids=[c["name"] for c in CASES])
def test_pod_mesh_step_matches_jax_global_batch(c, pod_ranks_out):
    import jax

    name, flips = c["name"], c["compress"] == "bf16"
    ranks = [torch.load(pod_ranks_out / f"{name}.{r}.pt", weights_only=False)
             for r in range(P * D)]
    jm, jst = tp.jax_run("dense", 1, P * D if c["accum"] > 1 else 1, c["mode"], c["accum"],
                         c["compress"])
    r0 = ranks[0]
    assert r0["accum"] == c["accum"], name
    for i, (t, j) in enumerate(zip(r0["metrics"], jm)):
        for k in ("loss", "ce", "aux"):
            _close(t[k], j[k], f"{name} step {i} {k}")
        _close(t["grad_norm"], j["grad_norm"], f"{name} step {i} grad_norm",
               atol=1e-4 if flips else ATOL)
    for r in ranks[1:]:
        assert r["metrics"] == r0["metrics"], name
    for j, (x, y) in enumerate(zip(tree_leaves(r0["whole"].params), jax.tree.leaves(jst.params))):
        x, y = _np(x), _np(y)
        np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL + PARAM_LR_FRAC * LR,
                                   err_msg=f"{name} params leaf {j}")
        loose = np.abs(x - y) > ATOL + RTOL * np.abs(y)
        share = BF16_FLIP_SHARE if flips else PARAM_LOOSE_SHARE
        assert loose.mean() <= share, f"{name} params leaf {j}: {loose.mean()}"
    for what in ("m", "v"):
        a, b = getattr(r0["whole"].opt, what), getattr(jst.opt, what)
        for j, (x, y) in enumerate(zip(tree_leaves(a), jax.tree.leaves(b))):
            _close(x, y, f"{name} {what} leaf {j}", flips=flips)
    assert any(d is not None for d in r0["dims"]), name  # FSDP cuts some leaf
    for r, x in enumerate(ranks):
        # each slice all-reduced over pod once a leaf a micro-batch, after the pod's reduction
        pod = x["groups"]["all_reduce"]["pod"]
        marked = set().union(*x["marked"])
        n = sum(p not in marked for p in x["paths"])
        assert pod["calls"] == tp.STEPS * c["accum"] * n, (name, r, pod)
        assert "?" not in marked, (name, r)
        if c["mode"] == "degraded":  # the factored leaves, reduced in the backward alone
            assert marked and all(not t.startswith("grad:") or t[5:] not in marked
                                  for kind in ("all_reduce", "reduce_scatter")
                                  for t in x["counts"].get(kind, {})), (name, r)
        gathers = x["counts"]["all_gather"]
        assert all(t.startswith("param:") or t.startswith("gather") for t in gathers), gathers
