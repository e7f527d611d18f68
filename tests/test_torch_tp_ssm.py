"""The SSM mixer cut over the ``model`` axis against the live JAX step on the
global batch, on the CPU.

tiny-ssm and tiny-hybrid (``tests/test_torch_ssm.py``'s copies of
``tests/conftest.py``'s configs: 8 SSM heads of 16 channels, d_state 16)
take three and two steps of ``make_train_step(..., mesh=...)`` from the
JAX package's initial state, one spawn of gloo ranks a mesh shape:

* (1, 2): ``off``, ``dynamic``, ``degraded``, ``degraded_sync``, sequence
  parallelism in ``dynamic`` and the pure 2-D ``sharding_mode="fsdp"`` in
  ``dynamic`` (the rules drop ``ssm_inner``: the mixer stays whole and the
  batch is cut over both axes);
* (2, 2): ``dynamic`` and ``fsdp`` ``dynamic``;
* (1, 4): ``dynamic``; tiny-hybrid's 2 KV heads stay whole there.

Each case is held against the JAX step on ``make_host_mesh()`` with
``ExecFlags(n_dp_shards=G)`` at the port's MoE group count, at
``tests/test_torch_dist.py``'s tolerances on losses and params and
``tests/test_torch_ssm.py``'s on the grad norm and the moments.
The checks of ``tests/test_torch_tp.py`` carry over: the pieces every
model rank holds are bitwise equal across them (``A_log``, ``D``,
``dt_bias`` whole, and the B and C columns of ``in_proj`` and channels of
``conv_w``/``conv_b`` inside the segmented slices), each slice has the
layout's local shape (``in_proj`` at 2·d_inner/M + 2·d_state + nh/M
columns, not 1/M), and every collective tag of the cut mixer is reached:
``tp:ssm_in``, ``tp:ssm_out``, ``tp:ssm_bc``, ``tp:ssm_heads``,
``tp:gate_norm``, and ``out_proj``'s row-parallel low-rank factor
(r, d) once a layer a step in ``degraded``.  A checkpoint written at (1, 2)
restores in one process to the gathered state, bitwise.

Also, without ranks: the segmented ``cut`` / ``gather_whole`` round trip,
bitwise, with a stub mesh at each model coordinate, and the cut
``gate_norm``'s gradient against the whole row's on threads standing for
the model ranks, which fails where its sum of squares' backward is the
identity (``reduce_from_model`` alone).
"""
import dataclasses
import functools
import os
import threading
from types import SimpleNamespace

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
    ATOL, LR, PARAM_LOOSE_SHARE, PARAM_LR_FRAC, PLANS, RANK, RTOL, S, STEPS, _close, _np,
)

B = 8
# tests/test_torch_ssm.py's grad-norm tolerance over three steps: AdamW's
# first updates are about lr·sign(g), so a gradient element near zero that
# the two packages round to opposite signs moves the next steps' norms (the
# one-process port's third tiny-ssm step already reads 1.8e-5 from the JAX
# step's)
GNORM_RTOL = 1e-4
# and its absolute tolerance on the moments after three steps
MOMENT_ATOL = 1e-5
# tiny-hybrid takes two steps (the first at the warm-up's lr 0): the
# one-process port's third step lands 3.1e-4 from the JAX step's grad norm
# and its moments 2.4e-3 of a leaf's largest element, past every tolerance
# here, where its first two land within 3.3e-6 and 7e-5 of a leaf's norm
HYBRID_STEPS = 2
# tests/test_torch_ssm.py's TINY (the copies of tests/conftest.py's)
CFGS = {
    "ssm": dict(name="tiny-ssm", family="ssm", n_layers=4, d_model=64, n_heads=1, n_kv_heads=1,
                d_ff=0, vocab_size=256, dtype="float32",
                ssm=dict(d_state=16, head_dim=16, chunk=8)),
    "hybrid": dict(name="tiny-hybrid", family="hybrid", n_layers=8, d_model=64, n_heads=4,
                   n_kv_heads=2, d_ff=128, vocab_size=256, dtype="float32", attn_every=4,
                   moe=dict(n_experts=4, top_k=2, d_ff_expert=32, every=2, offset=1,
                            capacity_factor=4.0),
                   ssm=dict(d_state=16, head_dim=16, chunk=8)),
}


def case(cfg, name, mode="dynamic", sync=False, sp=False, smode="tp_fsdp"):
    return dict(name=f"{cfg}-{name}", cfg=cfg, mode=mode, sync=sync, sp=sp, smode=smode)


def steps_of(name):
    return HYBRID_STEPS if name == "hybrid" else STEPS


def _both(*args, **kw):
    return [case(cfg, *args, **kw) for cfg in CFGS]


CASES = {
    (1, 2): (_both("off", mode="off") + _both("dynamic") + _both("degraded", mode="degraded")
             + _both("sync", mode="degraded", sync=True) + _both("sp-dynamic", sp=True)
             + _both("fsdp-dynamic", smode="fsdp")),
    (2, 2): _both("dynamic") + _both("fsdp-dynamic", smode="fsdp"),
    (1, 4): _both("dynamic"),
}


def _cfg(pkg, name):
    fields = dict(CFGS[name])
    for key, cls in (("moe", "MoEConfig"), ("ssm", "SSMConfig")):
        if key in fields:
            fields[key] = getattr(pkg, cls)(**fields[key])
    return pkg.ModelConfig(**fields)


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def ssm_ranks(mesh, cases, init_path, out_dir, ckpt_dir=""):
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
            tbase.ShapeConfig("t", S, B, "train"), ndb_mode=mode, total_steps=10,
            flags=ExecFlags(remat="ffn", ce_chunk=16), mesh=mesh,
            parallel=tbase.ParallelConfig(fsdp=True, sharding_mode=c["smode"],
                                          sequence_parallel=c["sp"]))
        st = to_local(init._replace(params=_clone(init.params),
                                    opt=type(init.opt)(*map(_clone, init.opt)),
                                    proj=_clone(init.proj)), step.layout)
        collectives.reset_counts()
        metrics = []
        for i in range(steps_of(c["cfg"])):
            extra = ({"keep": keep, "example_weight": w},) if mode == "dynamic" else ()
            st, m = step(st, src.batch(i, B, S), *extra)
            metrics.append({k: float(v) for k, v in m.items()})
        counts = collectives.counts()
        lay = step.layout
        whole = gather_state(st, lay)
        tp = step.model_axis
        torch.save({"metrics": metrics, "counts": counts, "local": st.params,
                    "local_m": st.opt.m, "dims": lay.dims, "mdims": lay.mdims,
                    "groups": lay.groups, "paths": lay.paths, "segs": lay.segs,
                    "widths": [lay.local_widths(k) if lay.seg(k) else None
                               for k in range(len(lay.dims))],
                    "local_shapes": [lay.local_shape(k) for k in range(len(lay.dims))],
                    "coords": mesh.coords, "ssm": tp is not None and tp.ssm,
                    "whole": whole if mesh.rank == 0 else None},
                   os.path.join(out_dir, f"{c['name']}.{mesh.rank}.pt"))
        if ckpt_dir and c["name"] == "ssm-dynamic":
            tckpt.save(st, ckpt_dir, STEPS, layout=lay)


# ---------------------------------------------------------------------------
# the JAX side (imported in the test process only)
# ---------------------------------------------------------------------------


@pytest.fixture(autouse=True)
def jax_zero_width_ffn_exact(monkeypatch):
    """``tests/test_torch_ssm.py``'s fixture: the JAX package's low-rank
    backward cannot reshape a zero-width FFN's cotangent, so the JAX side
    runs tiny-ssm's d_ff = 0 FFN exact (the same empty gradient)."""
    from repro.models import model as jmodel

    orig = jmodel.ffn_block

    def ffn_block(p, h, cfg, rules, *, proj=None, **kw):
        return orig(p, h, cfg, rules, proj=None if cfg.d_ff == 0 else proj, **kw)

    monkeypatch.setattr(jmodel, "ffn_block", ffn_block)


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
def jax_run(name, groups, mode):
    """Per-step metrics and the final state of the JAX step on the global
    batch in ``groups`` MoE routing groups."""
    import jax
    import jax.numpy as jnp

    from repro.configs import base as jbase
    from repro.launch.mesh import make_host_mesh
    from repro.launch.steps import make_train_step as jax_make_train_step
    from repro.models import model as jmodel

    jcfg = _cfg(jbase, name)
    keep, w = plan_to_masks(PLANS[B], _cfg(tbase, name), B)
    mesh = make_host_mesh()
    with mesh:
        jstep, sshard, *_ = jax_make_train_step(
            jcfg, jbase.TrainConfig(learning_rate=LR), jbase.ParallelConfig(fsdp=False),
            jbase.MeCeFOConfig(mode="dynamic", rank=RANK), mesh,
            jbase.ShapeConfig("t", S, B, "train"), ndb_mode=mode, total_steps=10,
            flags=jmodel.ExecFlags(remat="ffn", attn_chunk=S, ce_chunk=16, n_dp_shards=groups),
            donate=False)
        jst = jax.device_put(_jax_init(name), sshard)
    src = SyntheticLM(jcfg.vocab_size)
    metrics = []
    for i in range(steps_of(name)):
        extra = ({"keep": jnp.asarray(keep), "example_weight": jnp.asarray(w)},) \
            if mode == "dynamic" else ()
        with mesh:
            jst, jm = jstep(jst, src.batch(i, B, S), *extra)
        metrics.append({k: float(v) for k, v in jm.items()})
    return metrics, jax.tree.map(np.asarray, jst)


def init_file(tmp_path) -> str:
    import jax

    from repro_torch.bridge import state_from_numpy

    path = str(tmp_path / "init.pt")
    torch.save({n: state_from_numpy(jax.tree.map(np.asarray, _jax_init(n)), _cfg(tbase, n),
                                    device="cpu") for n in CFGS}, path)
    return path


def _pieces(x, r, k):
    """A segmented slice's pieces with their cut flags."""
    return zip(x.split(r["widths"][k], dim=r["mdims"][k]), (cut for _, cut in r["segs"][k]))


def check_case(c, D, M, ranks):
    """Metrics, the whole state and the slices of one case (the module
    docstring)."""
    import jax

    name = c["name"]
    shards = D * M if c["smode"] == "fsdp" else D
    groups = shards if c["cfg"] == "hybrid" else 1
    jm, jst = jax_run(c["cfg"], groups, c["mode"])
    r0 = ranks[0]
    assert r0["ssm"] == (c["smode"] == "tp_fsdp"), name
    assert len(r0["metrics"]) == len(jm) == steps_of(c["cfg"]), name
    for i, (t, j) in enumerate(zip(r0["metrics"], jm)):
        for k in ("loss", "ce", "aux"):
            _close(t[k], j[k], f"{name} step {i} {k}")
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"], rtol=GNORM_RTOL,
                                   err_msg=f"{name} step {i} grad_norm")
    for r in ranks[1:]:
        assert r["metrics"] == r0["metrics"], name
    got = r0["whole"]
    for j, (x, y) in enumerate(zip(tree_leaves(got.params), jax.tree.leaves(jst.params))):
        x, y = _np(x), _np(y)
        np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL + PARAM_LR_FRAC * LR,
                                   err_msg=f"{name} params leaf {j}")
        loose = np.abs(x - y) > ATOL + RTOL * np.abs(y)
        # test_torch_dist.py's share, or one element of a small leaf (tiny-hybrid's
        # conv_b: 1.08e-6 past 1e-6 on one of 320, from 0 at init)
        assert loose.sum() <= max(1, PARAM_LOOSE_SHARE * x.size), f"{name} leaf {j}: {loose.sum()}"
    for what, a, b in (("m", got.opt.m, jst.opt.m), ("v", got.opt.v, jst.opt.v)):
        for j, (x, y) in enumerate(zip(tree_leaves(a), jax.tree.leaves(b))):
            _close(x, y, f"{name} {what} leaf {j}", atol=MOMENT_ATOL)
    # a piece no axis between two ranks cuts is bitwise the same on both
    for r in ranks[1:]:
        same_d = r["coords"][0] == r0["coords"][0]
        for k, (x, y) in enumerate(zip(tree_leaves(r["local"]), tree_leaves(r0["local"]))):
            data_whole = r0["dims"][k] is None
            if not (same_d or data_whole) or r0["groups"][k] == ("data", "model"):
                continue
            if r0["mdims"][k] is None:
                assert torch.equal(x, y), f"{name} leaf {r0['paths'][k]}"
            elif r0["segs"] and r0["segs"][k]:  # B and C inside the segmented slices
                for (p, cut), (q, _) in zip(_pieces(x, r0, k), _pieces(y, r0, k)):
                    assert cut or torch.equal(p, q), f"{name} B/C of {r0['paths'][k]}"
    # each slice has the layout's local shape; the fused leaves' from the segments
    cfg = _cfg(tbase, c["cfg"])
    ssm = cfg.ssm
    d_inner = ssm.expand * cfg.d_model
    nh = d_inner // ssm.head_dim
    for k, x in enumerate(tree_leaves(r0["local"])):
        assert tuple(x.shape) == tuple(r0["local_shapes"][k]), (name, r0["paths"][k])
        if r0["ssm"] and r0["paths"][k].endswith("mixer.in_proj"):
            assert r0["widths"][k] == [d_inner // M, d_inner // M, 2 * ssm.d_state, nh // M]
            assert x.shape[-1] == 2 * d_inner // M + 2 * ssm.d_state + nh // M
    return r0


def tags(counts, kind):
    return set(counts.get(kind, {}))


def check_counts(c, r0, D, M):
    """The cut mixer's collectives (the module docstring)."""
    counts, name = r0["counts"], c["name"]
    ar = tags(counts, "all_reduce")
    if c["smode"] == "fsdp":  # no TP: the weights over both axes, the batch too
        assert not any(t.startswith("tp:") for k in counts for t in counts[k]), name
        return
    want = {"tp:ssm_bc", "tp:ssm_heads", "tp:gate_norm"}
    want |= {"sp:norm"} if c["sp"] else {"tp:ssm_in", "tp:ssm_out"}
    assert want <= ar, (name, want - ar)
    if c["sp"]:
        assert "sp:gather" in tags(counts, "all_gather"), name
        assert "sp:scatter" in tags(counts, "reduce_scatter"), name
    if c["mode"] == "degraded":  # out_proj's partial (r, d) factor, once a layer a step
        cfg = _cfg(tbase, c["cfg"])
        n_ssm = sum(cfg.layer_kind(i) == "ssm" for i in range(cfg.n_layers))
        outs = [p for p in r0["paths"] if p.endswith("mixer.out_proj")]
        by = counts["all_reduce"]
        for p in outs:
            tag = ("lowrank:" if c["sync"] else "lowrank_row:") + p
            n = steps_of(c["cfg"]) * n_ssm // len(outs)
            assert by[tag]["calls"] == n, (name, tag, by[tag])
            assert by[tag]["bytes"] == n * RANK * cfg.d_model * 4, (name, tag, by[tag])


@pytest.mark.parametrize("D,M", [(1, 2), (2, 2), (1, 4)])
def test_ssm_model_axis_step_matches_jax_global_batch(D, M, tmp_path):
    cases = CASES[(D, M)]
    init_path = init_file(tmp_path)
    ckpt_dir = str(tmp_path / "ckpt") if (D, M) == (1, 2) else ""
    spawn(ssm_ranks, D * M, cases, init_path, str(tmp_path), ckpt_dir, model=M, device="cpu",
          timeout=600)
    for c in cases:
        ranks = [torch.load(tmp_path / f"{c['name']}.{r}.pt", weights_only=False)
                 for r in range(D * M)]
        r0 = check_case(c, D, M, ranks)
        check_counts(c, r0, D, M)
    if ckpt_dir:  # written at (1, 2), restored by one process
        want = torch.load(tmp_path / "ssm-dynamic.0.pt", weights_only=False)["whole"]
        init = torch.load(init_path, weights_only=False)["ssm"]
        got, at = tckpt.restore(init, ckpt_dir)
        assert at == STEPS
        for part in ("params", "proj"):
            for a, b in zip(tree_leaves(getattr(got, part)), tree_leaves(getattr(want, part))):
                assert torch.equal(a, b)
        for a, b in zip(tree_leaves(got.opt.m) + tree_leaves(got.opt.v),
                        tree_leaves(want.opt.m) + tree_leaves(want.opt.v)):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# without ranks
# ---------------------------------------------------------------------------


class _StubComm:
    """A model group whose all-gather returns the slices every coordinate's
    layout cut (``slices[path]``), in rank order."""

    def __init__(self, slices):
        self.slices = slices

    def all_gather(self, x, dim, tag=""):
        return torch.cat(self.slices[tag.split(":", 1)[1]], dim=dim)


def _stub_mesh(M, m, comm=None):
    return SimpleNamespace(axis_names=("data", "model"), shape={"data": 1, "model": M},
                           sizes=(1, M), coords=(0, m), rank=m, model_comm=comm)


@pytest.mark.parametrize("name,M", [("ssm", 2), ("ssm", 4), ("hybrid", 2)])
def test_segmented_cut_round_trips_bitwise(name, M):
    from repro_torch.launch.state import shard_layout
    from repro_torch.launch.steps import build_rules, model_cuts
    from repro_torch.models.params import init_params

    cfg = _cfg(tbase, name)
    par = tbase.ParallelConfig(fsdp=False)
    whole = tree_leaves(init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    lays = [shard_layout(cfg, build_rules(cfg, _stub_mesh(M, m), par), _stub_mesh(M, m),
                         False, model_cuts(cfg, _stub_mesh(M, m), par)) for m in range(M)]
    cuts = [[lay.cut(x, k) for k, x in enumerate(whole)] for lay in lays]
    ssm = cfg.ssm
    d_inner, N = ssm.expand * cfg.d_model, ssm.d_state
    nh = d_inner // ssm.head_dim
    seen, owned = set(), []
    for m, (lay, mine) in enumerate(zip(lays, cuts)):
        own = 0
        for k, x in enumerate(mine):
            assert tuple(x.shape) == lay.local_shape(k), lay.paths[k]
            path = lay.paths[k]
            if path.endswith("mixer.in_proj"):  # [z_m | x_m | B | C | dt_m]
                w, q, h = whole[k], d_inner // M, nh // M
                want = torch.cat([w[..., m * q:(m + 1) * q], w[..., d_inner + m * q:
                                                               d_inner + (m + 1) * q],
                                  w[..., 2 * d_inner:2 * d_inner + 2 * N],
                                  w[..., 2 * d_inner + 2 * N + m * h:
                                    2 * d_inner + 2 * N + (m + 1) * h]], dim=-1)
                assert torch.equal(x, want)
                seen.add("in_proj")
            if path.endswith(("mixer.conv_w", "mixer.conv_b")):  # [x_m | B | C]
                w, q = whole[k], d_inner // M
                want = torch.cat([w[..., m * q:(m + 1) * q], w[..., d_inner:]], dim=-1)
                assert torch.equal(x, want)
                seen.add(path.rsplit(".", 1)[1])
            if lay.seg(k):
                own += sum(p.numel() for p in lay.own(x, k))
        owned.append(own)
    assert seen == {"in_proj", "conv_w", "conv_b"}
    # each element of a segmented leaf counts on one model rank only
    segmented = [k for k in range(len(whole)) if lays[0].seg(k)]
    assert sum(owned) == sum(whole[k].numel() for k in segmented)
    comm = _StubComm({lays[0].paths[k]: [c[k] for c in cuts] for k in range(len(whole))})
    for m in range(M):
        lay = dataclasses.replace(lays[m], mesh=_stub_mesh(M, m, comm))
        back = lay.gather_whole(cuts[m])
        for k, (a, b) in enumerate(zip(back, whole)):
            assert torch.equal(a, b), lay.paths[k]


class _ThreadComm:
    """A model group of ``world`` threads (all-reduce sum through shared
    slots)."""

    def __init__(self, slots, barrier, rank, world):
        self.slots, self.barrier, self.rank, self.world = slots, barrier, rank, world

    def all_reduce(self, t, op="sum", tag=""):
        self.slots[self.rank] = t.detach().clone()
        self.barrier.wait()
        red = torch.stack(self.slots).sum(0)
        self.barrier.wait()
        t.copy_(red)
        return t


def _cut_gate_norm_grads(M, x, scale, g, monkeypatch=None):
    """Each thread's (output, dx, dscale) of ``models/ssm.py:gate_norm`` on
    its channels of the rows ``x``."""
    from repro_torch.models.ssm import gate_norm

    slots, barrier, out = [None] * M, threading.Barrier(M), [None] * M

    def rank(m):
        tp = collectives.ModelAxis(_ThreadComm(slots, barrier, m, M), ssm=True)
        xm = x.chunk(M, -1)[m].clone().requires_grad_()
        sm = scale.chunk(M, -1)[m].clone().requires_grad_()
        y = gate_norm(xm, sm, x.shape[-1], 1e-5, tp)
        y.backward(g.chunk(M, -1)[m])
        out[m] = (y.detach(), xm.grad, sm.grad)

    threads = [threading.Thread(target=rank, args=(m,)) for m in range(M)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return [torch.cat([o[i] for o in out], -1) for i in range(3)]


@pytest.mark.parametrize("M", [2, 4])
def test_cut_gate_norm_gradient_matches_the_whole_rows(M, monkeypatch):
    from repro_torch.kernels.rmsnorm import rmsnorm_plain
    from repro_torch.models import ssm as tssm

    gen = torch.Generator().manual_seed(M)
    x = torch.randn((3, 5, 64), generator=gen) * torch.linspace(0.2, 3.0, 64)
    scale = 1.0 + 0.1 * torch.randn((64,), generator=gen)
    g = torch.randn((3, 5, 64), generator=gen)
    xw, sw = x.clone().requires_grad_(), scale.clone().requires_grad_()
    yw = rmsnorm_plain(xw, sw, 1e-5)
    yw.backward(g)
    y, dx, ds = _cut_gate_norm_grads(M, x, scale, g)
    np.testing.assert_allclose(y.numpy(), yw.detach().numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dx.numpy(), xw.grad.numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ds.numpy(), sw.grad.numpy(), rtol=1e-4, atol=1e-6)
    # the sum of squares' backward left the identity: each rank's channels
    # lose the other ranks' share of the gradient through the norm
    monkeypatch.setattr(tssm, "copy_to_model", lambda v, tp, tag: v)
    _, dx_id, _ = _cut_gate_norm_grads(M, x, scale, g)
    assert not np.allclose(dx_id.numpy(), xw.grad.numpy(), rtol=1e-4, atol=1e-6)
