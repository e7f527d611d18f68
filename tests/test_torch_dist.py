"""The port's data-parallel step across processes against the live JAX step
on the global batch, on the CPU.

Each case spawns W gloo ranks (``launch/dist.py:spawn``, one intra-op
thread each) on tiny-dense or tiny-moe (``tests/conftest.py``'s configs)
and runs, from the JAX package's initial state, three steps of
``make_train_step(..., mesh=...)`` in each NDB mode and in ``degraded``
with ``lowrank_sync``, replicated and under FSDP, plus accumulation 2 with
bf16 compression and a batch W does not divide (B 9).  The ranks write
their metrics, their own slices and the gathered state; the test holds
them against the JAX step on the global batch:

* the JAX step runs on the one CPU device with ``ExecFlags(n_dp_shards=W)``
  (its MoE routes in W groups, as on W devices) and, for accumulation, on
  the global batch permuted so that its contiguous micro-batches are the
  JAX package's per-shard interleave (``_split_micro``): micro-batch i
  holds every rank's i-th block of rows;
* ``degraded_sync`` is held against JAX's ``degraded`` step: on one
  device its ``_replicate`` is the identity, so both compute the same
  numbers;
* tolerances as in ``tests/test_torch_train_step.py`` (rtol 1e-5 / atol
  1e-6; params at atol 1e-6 + 0.1·lr with at most 1e-3 of a leaf's
  elements past 1e-6) and, with bf16 compression,
  ``tests/test_torch_accum.py``'s (moments within 2^-7 of the leaf's
  largest element, at most 1 % of a leaf's elements past rtol 1e-5, the
  grad norm at atol 1e-4);
* replicated leaves are bitwise equal on every rank;
* the collectives' byte counter: under ``degraded_sync`` each low-rank
  leaf's gradient is never reduced, and its (r, m) factors cross the wire
  at r/n of the bytes its (n, m) gradient takes under ``degraded``; under
  FSDP a rank holds 1/W of the sharded leaves' params and moments;
* a checkpoint written at W = 2 restores at W = 1, and one written by one
  process restores at W = 2 (dense, W = 2).

Also ``compress_psum`` against JAX's under ``jax.vmap``, the gather and
scatter routes against each other, and the spawner's failure path.  The
tiny-moe cases are in ``tests/test_torch_dist_moe.py`` (a second file, so
the two run on separate test workers).
"""
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import ckpt as tckpt  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core.ndb import NDBPlan, plan_to_masks  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.launch.dist import spawn  # noqa: E402
from repro_torch.launch.state import gather_state, to_local  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models.model import ExecFlags  # noqa: E402
from repro_torch.models.params import tree_leaves, tree_map  # noqa: E402
from repro_torch.parallel import collectives  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
PARAM_LR_FRAC, PARAM_LOOSE_SHARE = 0.1, 1e-3
BF16_FLIP_SHARE = 1e-2
S, RANK, LR, STEPS = 32, 8, 1e-3, 3
PLANS = {8: NDBPlan(n_dp=4, n_stages=2, failed=frozenset({(1, 0)})),
         9: NDBPlan(n_dp=3, n_stages=2, failed=frozenset({(1, 0)}))}
TINY = {
    "dense": dict(name="tiny-dense", n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                  d_ff=128, vocab_size=256, dtype="float32"),
    "moe": dict(name="tiny-moe", family="moe", n_layers=4, d_model=64, n_heads=4,
                n_kv_heads=2, d_ff=0, vocab_size=256, dtype="float32",
                moe=dict(n_experts=8, top_k=2, d_ff_expert=32, capacity_factor=4.0)),
}
# (name, ndb mode, fsdp, lowrank_sync, accum, compression, global batch)
CASES = [(f"{m}-{'fsdp' if f else 'rep'}", m, f, False, 1, "none", 8)
         for m in ("off", "dynamic", "static", "degraded") for f in (False, True)]
CASES += [("sync-rep", "degraded", False, True, 1, "none", 8),
          ("sync-fsdp", "degraded", True, True, 1, "none", 8),
          ("accum-bf16", "dynamic", True, False, 2, "bf16", 8),
          ("odd-batch", "dynamic", True, False, 1, "none", 9)]


def _cfg(pkg, kind, **kw):
    fields = dict(TINY[kind], **kw)
    if "moe" in fields:
        fields["moe"] = pkg.MoEConfig(**fields["moe"])
    return pkg.ModelConfig(**fields)


def _masks(cfg, B):
    return plan_to_masks(PLANS[B], cfg, B)


def _ranks(mesh, kind, init_path, out_dir, ckpt_dir):
    """One rank: every case from the initial state; writes its results."""
    cfg = _cfg(tbase, kind)
    init = torch.load(init_path, weights_only=False)
    src = SyntheticLM(cfg.vocab_size)
    for name, mode, fsdp, sync, accum, compress, B in CASES:
        mecefo = tbase.MeCeFOConfig(mode="dynamic", rank=RANK, lowrank_sync=sync)
        keep, w = _masks(cfg, B)
        step = make_train_step(
            cfg, tbase.TrainConfig(learning_rate=LR), mecefo, tbase.ShapeConfig("t", S, B, "train"),
            ndb_mode=mode, static_ndb=(keep, w) if mode == "static" else None, total_steps=10,
            flags=ExecFlags(remat="ffn", ce_chunk=16), mesh=mesh,
            parallel=tbase.ParallelConfig(fsdp=fsdp, accum=accum, grad_compression=compress))
        st = to_local(init._replace(params=_clone(init.params),
                                    opt=type(init.opt)(*map(_clone, init.opt))), step.layout)
        collectives.reset_counts()
        metrics = []
        for i in range(STEPS):
            extra = ({"keep": keep, "example_weight": w},) if mode == "dynamic" else ()
            st, m = step(st, src.batch(i, B, S), *extra)
            metrics.append({k: float(v) for k, v in m.items()})
        counts = collectives.counts()
        held = sum(x.numel() * x.element_size()
                   for t in (st.params, *st.opt) for x in tree_leaves(t))
        whole = gather_state(st, step.layout)
        torch.save({"metrics": metrics, "counts": counts, "held": held, "local": st.params,
                    "dims": step.layout.dims, "paths": step.layout.paths,
                    "shapes": step.layout.shapes,
                    "accum": step.accum, "rows": step.rows,
                    "whole": whole if mesh.rank == 0 else None},
                   os.path.join(out_dir, f"{name}.{mesh.rank}.pt"))
        if ckpt_dir and name == "dynamic-fsdp":
            tckpt.save(st, os.path.join(ckpt_dir, "from_ranks"), STEPS, layout=step.layout)
            got, _ = tckpt.restore(st, os.path.join(ckpt_dir, "from_one"), layout=step.layout)
            want = to_local(init, step.layout)
            for a, b in zip(tree_leaves(got.params) + tree_leaves(got.opt.v),
                            tree_leaves(want.params) + tree_leaves(want.opt.v)):
                assert torch.equal(a, b)


def trainer_rank(mesh, args, kwargs, init_path, out):
    """One rank of a ``Trainer(mesh=...)`` run (``tests/test_torch_trainer.py``,
    ``tests/test_torch_statexfer.py``): writes its history, accounting,
    incidents, receipts and replay verdict to ``out.<rank>.pt``."""
    from repro_torch.launch.train import Trainer

    state = torch.load(init_path, weights_only=False) if init_path else None
    tr = Trainer(*args, state=state, mesh=mesh, **kwargs)
    hist = tr.run(log_every=0)
    inc = tr.controller.incidents
    out_rec = {
        "hist": hist, "acc": tr.controller.accounting.as_dict(),
        "ok": tr.replay_agreed() if tr.replay_trace is not None else None,
        "writes": tr.writes, "recorder": tr.process.recorder is not None,
        "incidents": None if inc is None else [
            (i.kind, i.key, i.open_step, i.close_step, i.path, i.acct, i.n_events, i.unclosed)
            for i in inc.mgr.incidents],
        "receipts": [] if tr.xfer is None else [
            (r.rank, r.step, r.source, r.bytes_moved, r.snapshot_step, r.ok)
            for r in tr.xfer.receipts],
        "restored": None if tr.xfer is None else {
            k: tree_leaves(v.params) for k, v in tr.xfer.last_restored.items()},
        "state_nbytes": tr.controller.state_nbytes,
    }
    torch.save(out_rec, f"{out}.{mesh.rank}.pt")


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


# ---------------------------------------------------------------------------
# the JAX side (imported in the test process only)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_init(kind):
    import jax

    from repro.configs import base as jbase
    from repro.core.lowrank import refresh_projections
    from repro.launch.state import init_state

    jcfg = _cfg(jbase, kind)
    st = init_state(jcfg, jbase.TrainConfig(learning_rate=LR),
                    jbase.MeCeFOConfig(mode="dynamic", rank=RANK), jax.random.PRNGKey(0))
    return st._replace(proj=refresh_projections(st.params, jcfg, RANK))


def _perm(B, W, accum):
    """Row order whose contiguous micro-batches are the per-shard
    interleave of ``repro.launch.steps._split_micro``."""
    idx = np.arange(B)
    if accum == 1 or B % (W * accum):
        return idx
    return idx.reshape(W, accum, B // W // accum).swapaxes(0, 1).reshape(-1)


def _jax_run(kind, W, mode, accum, compress, B):
    """Per-step metrics and the final state of the JAX step on the global
    batch, as numpy.  ``static`` runs as ``dynamic`` (the same masks, baked
    in or passed), and dense models route no tokens: both share runs."""
    mode = "dynamic" if mode == "static" else mode
    return _jax_cached(kind, W if kind == "moe" else 1, W if accum > 1 else 1, mode, accum,
                       compress, B)


@functools.lru_cache(maxsize=None)
def _jax_cached(kind, groups, W, mode, accum, compress, B):
    """``groups``: the MoE routing groups; ``W``: the ranks the
    accumulation's interleave runs over."""
    import jax
    import jax.numpy as jnp

    from repro.configs import base as jbase
    from repro.launch.mesh import make_host_mesh
    from repro.launch.steps import make_train_step as jax_make_train_step
    from repro.models import model as jmodel

    jcfg = _cfg(jbase, kind)
    keep, w = _masks(_cfg(tbase, kind), B)
    perm = _perm(B, W, accum)
    keep, w = keep[:, perm], w[perm]
    mesh = make_host_mesh()
    with mesh:
        jstep, sshard, *_ = jax_make_train_step(
            jcfg, jbase.TrainConfig(learning_rate=LR),
            jbase.ParallelConfig(fsdp=False, accum=accum, grad_compression=compress),
            jbase.MeCeFOConfig(mode="dynamic", rank=RANK), mesh, jbase.ShapeConfig("t", S, B, "train"),
            ndb_mode=mode, static_ndb=(keep, w) if mode == "static" else None, total_steps=10,
            flags=jmodel.ExecFlags(remat="ffn", attn_chunk=S, ce_chunk=16, n_dp_shards=groups),
            donate=False)
        jst = jax.device_put(_jax_init(kind), sshard)
    src = SyntheticLM(jcfg.vocab_size)
    metrics = []
    for i in range(STEPS):
        batch = {k: v[perm] for k, v in src.batch(i, B, S).items()}
        extra = ({"keep": jnp.asarray(keep), "example_weight": jnp.asarray(w)},) \
            if mode == "dynamic" else ()
        with mesh:
            jst, jm = jstep(jst, batch, *extra)
        metrics.append({k: float(v) for k, v in jm.items()})
    return metrics, jax.tree.map(np.asarray, jst)


def _np(x):
    from repro_torch.bridge import tensor_to_numpy

    return tensor_to_numpy(x).astype(np.float32) if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(a, b, what, atol=ATOL, flips=False):
    a, b = _np(a), _np(b)
    if not flips:
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=atol, err_msg=what)
        return
    loose = np.abs(a - b) > atol + RTOL * np.abs(b)
    assert loose.mean() <= BF16_FLIP_SHARE, f"{what}: {loose.mean()}"
    np.testing.assert_allclose(a, b, rtol=0, atol=atol + 2.0 ** -7 * float(np.abs(b).max()),
                               err_msg=what)


def _check_case(kind, W, case, ranks):
    import jax

    name, mode, fsdp, _sync, accum, compress, B = case
    flips = compress == "bf16"
    jm, jst = _jax_run(kind, W, mode, accum, compress, B)
    r0 = ranks[0]
    assert r0["accum"] == accum
    for i, (t, j) in enumerate(zip(r0["metrics"], jm)):
        for k in ("loss", "ce", "aux"):
            _close(t[k], j[k], f"{name} step {i} {k}")
        _close(t["grad_norm"], j["grad_norm"], f"{name} step {i} grad_norm",
               atol=1e-4 if flips else ATOL)
        assert t["lr"] == pytest.approx(j["lr"], rel=1e-6, abs=1e-12)
    for r in ranks[1:]:
        assert r["metrics"] == r0["metrics"], name
    got = r0["whole"]
    for j, (x, y) in enumerate(zip(tree_leaves(got.params), jax.tree.leaves(jst.params))):
        x, y = _np(x), _np(y)
        np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL + PARAM_LR_FRAC * LR,
                                   err_msg=f"{name} params leaf {j}")
        loose = np.abs(x - y) > ATOL + RTOL * np.abs(y)
        share = BF16_FLIP_SHARE if flips else PARAM_LOOSE_SHARE
        assert loose.mean() <= share, f"{name} params leaf {j}: {loose.mean()}"
    for what, a, b in (("m", got.opt.m, jst.opt.m), ("v", got.opt.v, jst.opt.v)):
        for j, (x, y) in enumerate(zip(tree_leaves(a), jax.tree.leaves(b))):
            _close(x, y, f"{name} {what} leaf {j}", flips=flips)
    # replicated leaves bitwise on every rank; shards cut as the layout says
    for r in ranks[1:]:
        for x, y, d in zip(tree_leaves(r["local"]), tree_leaves(r0["local"]), r0["dims"]):
            if d is None:
                assert torch.equal(x, y), name
    for x, y, d in zip(tree_leaves(r0["local"]), tree_leaves(got.params), r0["dims"]):
        assert (d is not None) <= fsdp
        assert x.shape == y.shape if d is None else x.shape[d] * W == y.shape[d]


def _check_bytes(W, res):
    shapes = dict(zip(res["degraded-rep"][0]["paths"], res["degraded-rep"][0]["shapes"]))
    deg = res["degraded-rep"][0]["counts"]["all_reduce"]
    syn = res["sync-rep"][0]["counts"]["all_reduce"]
    lowrank = {t[len("lowrank:"):]: c for t, c in syn.items() if t.startswith("lowrank:")}
    assert lowrank, "no factored all-reduce"
    for path, c in lowrank.items():
        n = shapes[path][-2]
        assert "grad:" + path not in syn, f"{path} reduced twice"
        assert c["bytes"] * n == deg["grad:" + path]["bytes"] * RANK, path
        assert c["calls"] == STEPS * shapes[path][0], path  # once a layer a step
    # the other leaves' gradient traffic is unchanged
    assert {t: c for t, c in deg.items() if t[5:] not in lowrank and t.startswith("grad:")} == \
        {t: c for t, c in syn.items() if t.startswith("grad:")}
    # FSDP: 1/W of the sharded leaves' params and moments, the rest whole
    rep, fs = res["dynamic-rep"][0], res["dynamic-fsdp"][0]
    n_moments = 3  # params, m, v
    whole = sum(4 * int(np.prod(shapes[p])) for p, d in zip(fs["paths"], fs["dims"]) if d is None)
    assert rep["held"] == n_moments * sum(4 * int(np.prod(s)) for s in shapes.values())
    assert fs["held"] * W == rep["held"] + (W - 1) * n_moments * whole


@pytest.mark.parametrize("kind,W", [("dense", 2), ("dense", 4)])
def test_mesh_step_matches_jax_global_batch(kind, W, tmp_path):
    mesh_case(kind, W, tmp_path)


def mesh_case(kind, W, tmp_path):
    """One spawn of W ranks over every case, held against the JAX step
    (the module docstring)."""
    import jax

    from repro_torch.bridge import state_from_numpy

    cfg = _cfg(tbase, kind)
    init = state_from_numpy(jax.tree.map(np.asarray, _jax_init(kind)), cfg, device="cpu")
    init_path = str(tmp_path / "init.pt")
    torch.save(init, init_path)
    ckpt_dir = str(tmp_path / "ckpt") if (kind, W) == ("dense", 2) else ""
    if ckpt_dir:
        tckpt.save(init, os.path.join(ckpt_dir, "from_one"), 0)
    spawn(_ranks, W, kind, init_path, str(tmp_path), ckpt_dir, device="cpu", timeout=600)
    res = {c[0]: [torch.load(str(tmp_path / f"{c[0]}.{r}.pt"), weights_only=False)
                  for r in range(W)] for c in CASES}
    for case in CASES:
        _check_case(kind, W, case, res[case[0]])
    assert res["odd-batch"][0]["rows"] == slice(0, 9)  # not sharded: every rank all rows
    _check_bytes(W, res)
    if ckpt_dir:  # written at W = 2, restored by one process
        got, step = tckpt.restore(init, os.path.join(ckpt_dir, "from_ranks"))
        want = res["dynamic-fsdp"][0]["whole"]
        assert step == STEPS
        for a, b in zip(tree_leaves(got.params) + tree_leaves(got.opt.m),
                        tree_leaves(want.params) + tree_leaves(want.opt.m)):
            assert torch.equal(a, b)


def test_compress_psum_matches_jax_under_vmap():
    """``compress_psum`` over 2 gloo ranks against JAX's under
    ``jax.vmap(..., axis_name=...)``: the int8 path bitwise, the plain
    path within f32 rounding."""
    import jax

    from repro.core.grad_sync import compress_psum as jax_compress

    rng = np.random.default_rng(0)
    tree = {"big": rng.standard_normal((2, 64, 96)).astype(np.float32),
            "small": rng.standard_normal((2, 10, 7)).astype(np.float32)}
    want = {m: jax.tree.map(np.asarray, jax.vmap(lambda t: jax_compress(t, "d", m),
                                                  axis_name="d")(tree))
            for m in ("int8", "none")}
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        np.savez(os.path.join(tmp, "in.npz"), **tree)
        spawn(_psum_ranks, 2, tmp, device="cpu", timeout=300)
        for r in range(2):
            got = torch.load(os.path.join(tmp, f"psum.{r}.pt"), weights_only=False)
            for k in tree:
                assert np.array_equal(got["int8"][k].numpy(), want["int8"][k][r]), k
                np.testing.assert_allclose(got["none"][k].numpy(), want["none"][k][r],
                                           rtol=1e-6, atol=1e-6)
            counts = got["counts"]
            assert counts["all_reduce_max"]["compress_psum"]["calls"] == 1  # the one big leaf


def _psum_ranks(mesh, tmp):
    from repro_torch.core.grad_sync import compress_psum

    data = np.load(os.path.join(tmp, "in.npz"))
    tree = {k: torch.from_numpy(data[k][mesh.rank].copy()) for k in data.files}
    collectives.reset_counts()
    out = {m: compress_psum(tree, mesh, m) for m in ("int8", "none")}
    torch.save(dict(out, counts=collectives.counts()), os.path.join(tmp, f"psum.{mesh.rank}.pt"))


def test_spawn_raises_a_rank_failure():
    with pytest.raises(Exception, match="rank 1 fails"):
        spawn(_failing_rank, 2, device="cpu", timeout=120)


def _failing_rank(mesh):
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails")


def test_mesh_refuses_what_it_does_not_run():
    """Every model family takes a model axis, SP and the 2-D ``fsdp`` mode
    (the SSM families with the mixer's ``ssm_inner`` cut), and a ``pod``
    axis before ``data``; other data axes are refused."""
    import dataclasses

    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.device.type == "cpu"
    # as the JAX package's, a mesh larger than the group shrinks to (group, 1)
    assert make_host_mesh(1, 2, device="cpu").shape == {"data": 1, "model": 1}
    cfg = _cfg(tbase, "dense")
    two = {"data": 1, "model": 2}
    for par in (tbase.ParallelConfig(sharding_mode="fsdp"),
                tbase.ParallelConfig(sequence_parallel=True), tbase.ParallelConfig()):
        par.check(two, cfg)
        par.check(two, _cfg(tbase, "moe"))
        make_train_step(cfg, tbase.TrainConfig(), tbase.MeCeFOConfig(),
                        tbase.ShapeConfig("t", S, 8, "train"), mesh=mesh, parallel=par)
    for family in ("ssm", "hybrid"):
        for par in (tbase.ParallelConfig(), tbase.ParallelConfig(sharding_mode="fsdp")):
            par.check(two, dataclasses.replace(cfg, family=family))
        tbase.ParallelConfig().check({"data": 2, "model": 1}, dataclasses.replace(cfg, family=family))
    tbase.ParallelConfig(dp_axes=("pod", "data")).check({"pod": 2, **two}, cfg)
    with pytest.raises(NotImplementedError, match="the port runs"):
        tbase.ParallelConfig(dp_axes=("replica",)).check(two, cfg)


def test_launch_helpers_default_to_the_card(tmp_path, monkeypatch):
    """``spawn``, ``init_process_group`` and ``make_host_mesh`` run on CUDA
    unless the caller asks for the CPU: where CUDA is absent (as here, or
    made so) each raises ``resolve_device``'s error, before any rank or
    group starts."""
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.launch.dist import init_process_group
    from repro_torch.launch.mesh import make_host_mesh

    msg = "CUDA is not available"
    with pytest.raises(RuntimeError, match=msg):
        spawn(_failing_rank, 2, timeout=60)
    with pytest.raises(RuntimeError, match=msg):
        init_process_group(0, 1, init_method=f"file://{tmp_path}/rendezvous")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match=msg):
        make_host_mesh()


def test_collective_routes_agree():
    """The ``all_reduce`` route (gloo on CUDA tensors has only all-reduce and
    broadcast) gathers and reduce-scatters along every dim the bits the
    native route does; here on the CPU with the route forced."""
    spawn(_routes_rank, 2, device="cpu", timeout=120)


def _routes_rank(mesh):
    native = mesh.comm
    via = collectives.Comm(native.group, native.device, native.rank, native.world)
    via.route = "all_reduce"
    x = torch.randn(6, 4, 10, generator=torch.Generator().manual_seed(mesh.rank))
    for d in range(3):
        assert torch.equal(native.all_gather(x, d), via.all_gather(x, d)), d
        assert torch.equal(native.reduce_scatter(x, d), via.reduce_scatter(x, d)), d
    assert torch.equal(native.all_gather(x, 1).chunk(2, 1)[mesh.rank], x)
