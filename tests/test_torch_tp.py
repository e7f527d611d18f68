"""The port's ``model`` mesh axis against the live JAX step on the global
batch, on the CPU.

Each mesh shape is one spawn of gloo ranks (``launch/dist.py:spawn`` with
``model=M``) that runs every case of that shape from the JAX package's
initial state: three steps of ``make_train_step(..., mesh=...)`` with
tensor parallelism over heads, FFN and vocab (``sharding_mode="tp_fsdp"``,
FSDP over ``data``), in each NDB mode, ``degraded_sync``, accumulation 2
with bf16 compression, sequence parallelism and the pure 2-D
``sharding_mode="fsdp"``; at (1, 4) tiny-dense's 2 KV heads do not divide
the axis, so ``wk``/``wv`` stay whole.  A padded vocabulary with tied
embeddings runs at (1, 2), ``q_norm``/``k_norm`` (one scale every head
shares) at (1, 2) and (1, 4).  The ranks write their metrics, slices,
counters and the gathered state; the test holds them against the JAX step
on the global batch, with ``ExecFlags(n_dp_shards=G)`` at the port's group
count and the accumulation's per-shard interleave over the batch shards
(``tests/test_torch_dist.py``'s ``_perm``), at ``tests/test_torch_dist.py``'s
tolerances:

* the whole leaves every model rank holds (and every data rank, where not
  FSDP-cut) are bitwise equal across them; a model-cut leaf is held at
  exactly 1/M;
* every collective tag of the path is reached; the attention's and the
  FFN's output all-reduces run once a layer a step on (B/D, S, d) f32;
* a row-parallel low-rank factor (``w_down``) is all-reduced once a layer a
  step as (r, d), over the model group in ``degraded`` and over the world
  in ``degraded_sync``, and its gradient is never reduced again.

Also each autograd collective's forward and backward against the
one-process computation at mesh (2, 2) (both routes of the all-to-all),
and a checkpoint written at (2, 2) restored at (1, 1) and (1, 2).  The
MoE cases are in ``tests/test_torch_tp_moe.py``, the Trainer's in
``tests/test_torch_tp_trainer.py`` (separate files, so they run on
separate test workers).
"""
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import ckpt as tckpt  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core.ndb import plan_to_masks  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.launch.dist import spawn  # noqa: E402
from repro_torch.launch.state import gather_state, to_local  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models.model import ExecFlags  # noqa: E402
from repro_torch.models.params import tree_leaves, tree_map  # noqa: E402
from repro_torch.parallel import collectives  # noqa: E402
from tests.test_torch_dist import (  # noqa: E402
    ATOL, BF16_FLIP_SHARE, LR, PARAM_LOOSE_SHARE, PARAM_LR_FRAC, PLANS, RANK, RTOL, S, STEPS,
    TINY, _close, _np, _perm,
)

B = 8
CFGS = {
    "dense": TINY["dense"],
    "dense-pad": dict(TINY["dense"], vocab_size=250, tie_embeddings=True),
    "dense-qk": dict(TINY["dense"], qk_norm=True),
    "moe": dict(TINY["moe"], moe=dict(TINY["moe"]["moe"], capacity_factor=1.0)),
}


def case(name, cfg="dense", mode="dynamic", sync=False, accum=1, compress="none", sp=False,
         smode="tp_fsdp"):
    return dict(name=name, cfg=cfg, mode=mode, sync=sync, accum=accum, compress=compress, sp=sp,
                smode=smode)


BASE = [case(m, mode=m) for m in ("off", "dynamic", "static", "degraded")]
BASE += [case("sync", mode="degraded", sync=True), case("accum-bf16", accum=2, compress="bf16")]
CASES = {
    (1, 2): BASE + [case("sp-dynamic", sp=True), case("sp-degraded", mode="degraded", sp=True),
                    case("fsdp-dynamic", smode="fsdp"),
                    case("fsdp-sync", mode="degraded", sync=True, smode="fsdp"),
                    case("pad-tied", cfg="dense-pad"), case("qk-norm", cfg="dense-qk")],
    (2, 2): BASE + [case("sp-dynamic", sp=True), case("fsdp-dynamic", smode="fsdp"),
                    case("fsdp-accum-bf16", accum=2, compress="bf16", smode="fsdp")],
    (1, 4): BASE + [case("qk-norm", cfg="dense-qk")],
}


def _cfg(pkg, name):
    fields = dict(CFGS[name])
    if "moe" in fields:
        fields["moe"] = pkg.MoEConfig(**fields["moe"])
    return pkg.ModelConfig(**fields)


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def tp_ranks(mesh, cases, init_path, out_dir, ckpt_dir=""):
    """One rank: every case from its config's initial state; writes its
    results to ``<case>.<rank>.pt``."""
    inits = torch.load(init_path, weights_only=False)
    for c in cases:
        cfg = _cfg(tbase, c["cfg"])
        init = inits[c["cfg"]]
        src = SyntheticLM(cfg.vocab_size)
        keep, w = plan_to_masks(PLANS[B], cfg, B)
        mode = c["mode"]
        step = make_train_step(
            cfg, tbase.TrainConfig(learning_rate=LR),
            tbase.MeCeFOConfig(mode="dynamic", rank=RANK, lowrank_sync=c["sync"]),
            tbase.ShapeConfig("t", S, B, "train"), ndb_mode=mode,
            static_ndb=(keep, w) if mode == "static" else None, total_steps=10,
            flags=ExecFlags(remat="ffn", ce_chunk=16), mesh=mesh,
            parallel=tbase.ParallelConfig(fsdp=True, sharding_mode=c["smode"],
                                          sequence_parallel=c["sp"], accum=c["accum"],
                                          grad_compression=c["compress"]))
        st = to_local(init._replace(params=_clone(init.params),
                                    opt=type(init.opt)(*map(_clone, init.opt)),
                                    proj=_clone(init.proj)), step.layout)
        collectives.reset_counts()
        metrics = []
        for i in range(STEPS):
            extra = ({"keep": keep, "example_weight": w},) if mode == "dynamic" else ()
            st, m = step(st, src.batch(i, B, S), *extra)
            metrics.append({k: float(v) for k, v in m.items()})
        counts = collectives.counts()
        lay = step.layout
        whole = gather_state(st, lay)
        torch.save({"metrics": metrics, "counts": counts, "local": st.params,
                    "local_m": st.opt.m, "dims": lay.dims, "mdims": lay.mdims,
                    "groups": lay.groups, "paths": lay.paths, "shapes": lay.shapes,
                    "coords": mesh.coords, "accum": step.accum, "rows": step.rows,
                    "whole": whole if mesh.rank == 0 else None},
                   os.path.join(out_dir, f"{c['name']}.{mesh.rank}.pt"))
        if ckpt_dir and c["name"] == "dynamic":
            tckpt.save(st, ckpt_dir, STEPS, layout=lay)


def restore_ranks(mesh, ckpt_dir, init_path, out_dir):
    """Restore a checkpoint onto this mesh and write the gathered state."""
    init = torch.load(init_path, weights_only=False)["dense"]
    step = make_train_step(_cfg(tbase, "dense"), tbase.TrainConfig(learning_rate=LR),
                           tbase.MeCeFOConfig(mode="dynamic", rank=RANK),
                           tbase.ShapeConfig("t", S, B, "train"), mesh=mesh,
                           parallel=tbase.ParallelConfig(fsdp=True))
    like = to_local(init, step.layout)
    got, at = tckpt.restore(like, ckpt_dir, layout=step.layout)
    assert at == STEPS
    for a, b in zip(tree_leaves(got.params), tree_leaves(like.params)):
        assert a.shape == b.shape
    whole = gather_state(got, step.layout)
    if mesh.rank == 0:
        torch.save(whole, os.path.join(out_dir, "restored.pt"))


# ---------------------------------------------------------------------------
# the JAX side (imported in the test process only)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_init(name):
    import jax

    from repro.configs import base as jbase
    from repro.core.lowrank import refresh_projections
    from repro.launch.state import init_state

    jcfg = _cfg(jbase, name)
    st = init_state(jcfg, jbase.TrainConfig(learning_rate=LR),
                    jbase.MeCeFOConfig(mode="dynamic", rank=RANK), jax.random.PRNGKey(0))
    return st._replace(proj=refresh_projections(st.params, jcfg, RANK))


@functools.lru_cache(maxsize=None)
def jax_run(name, groups, W, mode, accum, compress):
    """Per-step metrics and the final state of the JAX step on the global
    batch: ``groups`` MoE routing groups, the accumulation's interleave
    over ``W`` batch shards.  ``static`` runs as ``dynamic``."""
    import jax
    import jax.numpy as jnp

    from repro.configs import base as jbase
    from repro.launch.mesh import make_host_mesh
    from repro.launch.steps import make_train_step as jax_make_train_step
    from repro.models import model as jmodel

    mode = "dynamic" if mode == "static" else mode
    jcfg = _cfg(jbase, name)
    keep, w = plan_to_masks(PLANS[B], _cfg(tbase, name), B)
    perm = _perm(B, W, accum)
    keep, w = keep[:, perm], w[perm]
    mesh = make_host_mesh()
    with mesh:
        jstep, sshard, *_ = jax_make_train_step(
            jcfg, jbase.TrainConfig(learning_rate=LR),
            jbase.ParallelConfig(fsdp=False, accum=accum, grad_compression=compress),
            jbase.MeCeFOConfig(mode="dynamic", rank=RANK), mesh, jbase.ShapeConfig("t", S, B, "train"),
            ndb_mode=mode, total_steps=10,
            flags=jmodel.ExecFlags(remat="ffn", attn_chunk=S, ce_chunk=16, n_dp_shards=groups),
            donate=False)
        jst = jax.device_put(_jax_init(name), sshard)
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


def init_file(tmp_path, names) -> str:
    import jax

    from repro_torch.bridge import state_from_numpy

    path = str(tmp_path / "init.pt")
    torch.save({n: state_from_numpy(jax.tree.map(np.asarray, _jax_init(n)), _cfg(tbase, n),
                                    device="cpu") for n in names}, path)
    return path


def check_case(c, D, M, ranks):
    """Metrics, the whole state and the slices of one case (the module
    docstring)."""
    import jax

    name, flips = c["name"], c["compress"] == "bf16"
    shards = D * M if c["smode"] == "fsdp" else D
    groups = shards if c["cfg"] == "moe" else 1
    jm, jst = jax_run(c["cfg"], groups, shards if c["accum"] > 1 else 1, c["mode"],
                      c["accum"], c["compress"])
    r0 = ranks[0]
    assert r0["accum"] == c["accum"], name
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
    # a piece no axis between two ranks cuts is bitwise the same on both
    for r in ranks[1:]:
        same_d = r["coords"][0] == r0["coords"][0]
        for k, (x, y) in enumerate(zip(tree_leaves(r["local"]), tree_leaves(r0["local"]))):
            model_whole = r0["mdims"][k] is None and r0["groups"][k] != "world"
            data_whole = r0["dims"][k] is None
            if model_whole and (same_d or data_whole):
                assert torch.equal(x, y), f"{name} leaf {r0['paths'][k]}"
    # each slice is its share of the whole leaf; a model cut is exactly 1/M
    for k, (x, y) in enumerate(zip(tree_leaves(r0["local"]), tree_leaves(got.params))):
        md, d, g = r0["mdims"][k], r0["dims"][k], r0["groups"][k]
        pieces = (M if md is not None else 1) * ({"data": D, "world": D * M}[g] if d is not None
                                                 else 1)
        assert x.numel() * pieces == y.numel(), f"{name} leaf {r0['paths'][k]}"
        if md is not None:
            assert x.shape[md] * M == y.shape[md]
    return r0


def tags(counts, kind):
    return set(counts.get(kind, {}))


def check_counts(c, r0, cfg, D, M):
    """The model axis's collectives of one case (the module docstring)."""
    counts, name = r0["counts"], c["name"]
    ar = counts.get("all_reduce", {})
    L, d = cfg.n_layers, cfg.d_model
    rows = B // D
    if c["smode"] == "fsdp":  # no TP: the weights over both axes, the batch too
        assert not any(t.startswith("tp:") for k in counts for t in counts[k]), name
        assert any(t.startswith("param:") for t in tags(counts, "all_gather")), name
        return
    want = {"tp:ce_in", "tp:ffn_in"} if not c["sp"] else {"sp:norm"}
    if c["mode"] != "degraded" and not c["sp"]:  # all-degraded: no MHA backward
        want |= {"tp:attn_in", "tp:kv"} if M == 4 else {"tp:attn_in"}
    assert want <= tags(counts, "all_reduce"), (name, want - tags(counts, "all_reduce"))
    assert "tp:vocab" in tags(counts, "all_reduce_max"), name
    if c["sp"]:
        assert {"sp:gather", "sp:split"} <= tags(counts, "all_gather"), name
        assert "sp:scatter" in tags(counts, "reduce_scatter"), name
        assert not {"tp:attn_out", "tp:ffn_out"} & tags(counts, "all_reduce"), name
        return
    # the sublayers' output all-reduces: once a layer a step, (B/D, S, d) f32
    for t in ("tp:attn_out", "tp:ffn_out", "tp:embed"):
        n = STEPS * c["accum"] * (L if t != "tp:embed" else 1)
        assert ar[t]["calls"] == n, (name, t, ar[t])
        assert ar[t]["bytes"] == n * (rows // c["accum"]) * S * d * 4, (name, t, ar[t])
    if c["mode"] == "degraded":
        r = RANK
        down = [p for p in r0["paths"] if p.endswith("ffn.w_down")]
        rs = tags(counts, "reduce_scatter")
        for p in down:
            tag = ("lowrank:" if c["sync"] else "lowrank_row:") + p
            assert ar[tag]["calls"] == STEPS * L, (name, tag, ar[tag])
            assert ar[tag]["bytes"] == STEPS * L * r * d * 4, (name, tag, ar[tag])  # (r, d)
            if c["sync"]:
                assert "grad:" + p not in ar and "grad:" + p not in rs, name
                assert "lowrank_row:" + p not in ar, name
        if c["sync"]:  # the column-parallel factors: (r, d_ff/M), over data
            for p in r0["paths"]:
                if p.endswith(("ffn.w_up", "ffn.w_gate")):
                    assert ar["lowrank:" + p]["bytes"] == STEPS * L * r * (cfg.d_ff // M) * 4


@pytest.mark.parametrize("D,M", [(1, 2), (2, 2), (1, 4)])
def test_model_axis_step_matches_jax_global_batch(D, M, tmp_path):
    cases = CASES[(D, M)]
    names = sorted({c["cfg"] for c in cases})
    init_path = init_file(tmp_path, names)
    ckpt_dir = str(tmp_path / "ckpt") if (D, M) == (2, 2) else ""
    spawn(tp_ranks, D * M, cases, init_path, str(tmp_path), ckpt_dir, model=M, device="cpu",
          timeout=600)
    for c in cases:
        ranks = [torch.load(tmp_path / f"{c['name']}.{r}.pt", weights_only=False)
                 for r in range(D * M)]
        r0 = check_case(c, D, M, ranks)
        check_counts(c, r0, _cfg(tbase, c["cfg"]), D, M)
    if ckpt_dir:  # written at (2, 2): restored by one process and at (1, 2)
        want = torch.load(tmp_path / f"dynamic.0.pt", weights_only=False)["whole"]
        init = torch.load(init_path, weights_only=False)["dense"]
        got, at = tckpt.restore(init, ckpt_dir)
        assert at == STEPS
        spawn(restore_ranks, 2, ckpt_dir, init_path, str(tmp_path), model=2, device="cpu",
              timeout=300)
        again = torch.load(tmp_path / "restored.pt", weights_only=False)
        for tree in (got, again):
            for a, b in zip(tree_leaves(tree.params) + tree_leaves(tree.opt.m)
                            + tree_leaves(tree.opt.v) + tree_leaves(tree.proj),
                            tree_leaves(want.params) + tree_leaves(want.opt.m)
                            + tree_leaves(want.opt.v) + tree_leaves(want.proj)):
                assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the autograd collectives
# ---------------------------------------------------------------------------


def _inputs(rank, shape, salt):
    return torch.randn(shape, generator=torch.Generator().manual_seed(100 * salt + rank),
                       dtype=torch.float64)


def collectives_rank(mesh):
    """Each autograd collective's forward and backward on the model group
    against the one-process computation from every rank's inputs."""
    tp = collectives.ModelAxis(mesh.model_comm)
    M, m = tp.size, tp.rank
    d = mesh.coords[0]
    peers = [d * M + j for j in range(M)]  # world ranks of this model group

    def each(shape, salt):
        return [_inputs(p, shape, salt) for p in peers]

    def run(fn, x, g):
        x = x.clone().requires_grad_()
        y = fn(x)
        y.backward(g)
        return y.detach(), x.grad

    xs, gs = each((2, 4 * M, 3), 1), each((2, 4 * M, 3), 2)
    # copy_to_model: identity; backward the sum of the ranks' gradients
    y, gx = run(lambda x: collectives.copy_to_model(x, tp, "t"), xs[0], gs[m])
    assert torch.equal(y, xs[0]) and torch.allclose(gx, sum(gs), atol=1e-12)
    # reduce_from_model: the sum; backward the gradient unchanged
    y, gx = run(lambda x: collectives.reduce_from_model(x, tp, "t"), xs[m], gs[0])
    assert torch.allclose(y, sum(xs), atol=1e-12) and torch.equal(gx, gs[0])
    # gather_along: the concatenation; backward this rank's slice, or with
    # reduce_grad the slice of the ranks' summed gradients
    whole_g = each((2, 4 * M * M, 3), 3)
    y, gx = run(lambda x: collectives.gather_along(x, tp, 1, "t"), xs[m], whole_g[0])
    assert torch.equal(y, torch.cat(xs, 1)) and torch.equal(gx, whole_g[0].chunk(M, 1)[m])
    y, gx = run(lambda x: collectives.gather_along(x, tp, 1, "t", reduce_grad=True), xs[m],
                whole_g[m])
    assert torch.allclose(gx, sum(whole_g).chunk(M, 1)[m], atol=1e-12)
    # scatter_along: this rank's slice of the sum; backward the gathered gradient
    small = each((2, 4, 3), 4)
    y, gx = run(lambda x: collectives.scatter_along(x, tp, 1, "t"), xs[m], small[m])
    assert torch.allclose(y, sum(xs).chunk(M, 1)[m], atol=1e-12)
    assert torch.equal(gx, torch.cat(small, 1))
    # split_along: this rank's slice; backward the gathered gradient
    y, gx = run(lambda x: collectives.split_along(x, tp, 1, "t"), xs[0], small[m])
    assert torch.equal(y, xs[0].chunk(M, 1)[m]) and torch.equal(gx, torch.cat(small, 1))
    # all_to_all: chunk j to rank j; backward the reverse exchange
    a2a_x, a2a_g = each((2 * M, 3), 5), each((2 * M, 3), 6)
    y, gx = run(lambda x: collectives.all_to_all(x, tp, "t"), a2a_x[m], a2a_g[m])
    assert torch.equal(y, torch.cat([a2a_x[j].chunk(M)[m] for j in range(M)]))
    assert torch.equal(gx, torch.cat([a2a_g[j].chunk(M)[m] for j in range(M)]))
    via = collectives.Comm(tp.comm.group, tp.comm.device, tp.comm.rank, tp.comm.world)
    via.route = "all_reduce"  # gloo on CUDA tensors
    assert torch.equal(via.all_to_all(a2a_x[m]), tp.comm.all_to_all(a2a_x[m]))
    # the data group joins the same model coordinate of every data row
    t = torch.tensor([float(mesh.rank)], dtype=torch.float64)
    D = mesh.sizes[0]
    assert mesh.comm.all_reduce(t.clone())[0] == sum(i * M + m for i in range(D))
    assert mesh.world_comm.all_reduce(t.clone())[0] == sum(range(D * M))


def test_autograd_collectives_match_one_process():
    spawn(collectives_rank, 4, model=2, device="cpu", timeout=300)


def env_rank(rank, world, port):
    """A ``torchrun`` rank: the mesh from the environment, with a model axis."""
    from repro_torch.launch.dist import destroy, init_from_env

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    mesh = init_from_env(device="cpu", model=2)
    try:
        assert mesh.sizes == (world // 2, 2) and mesh.coords == (rank // 2, rank % 2)
        t = torch.tensor([float(rank)], dtype=torch.float64)
        assert mesh.model_comm.all_reduce(t.clone())[0] == sum(range(rank // 2 * 2,
                                                                    rank // 2 * 2 + 2))
        assert mesh.comm.all_reduce(t.clone())[0] == sum(range(rank % 2, world, 2))
    finally:
        destroy()


def test_init_from_env_builds_the_model_axis():
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.start_processes(env_rank, args=(4, port), nprocs=4, join=True, start_method="spawn")
