"""The port's ``pod`` mesh axis against the live JAX steps on the global
batch, on the CPU, and the production meshes' shape.

Each (pod, data, model) mesh is one spawn of gloo ranks
(``launch/dist.py:spawn`` with ``pod=P, model=M``) that runs three train
steps of ``make_train_step(..., mesh=...)`` from the JAX package's initial
state (``tests/test_torch_tp.py:tp_ranks``) and a prefill with 8 greedy
decode steps (``tests/test_torch_serve_mesh.py:serve_ranks``), for a
dense config under ``sharding_mode="tp_fsdp"`` and ``"fsdp"`` and the MoE
config, whose tokens route in groups over ``(pod, data)`` (and ``model``
under ``"fsdp"``).  The JAX steps on one device stand for the mesh with
``ExecFlags(n_dp_shards=G)``, G the port's batch shards, at the
tolerances of ``tests/test_torch_dist.py`` (train) and
``tests/test_torch_serve_mesh.py`` (serve).  Also:

* the ranks of two pods at the same (data, model) coordinate hold bitwise
  equal slices (``pod`` cuts no leaf), and each gradient is all-reduced
  over ``pod`` once a step, after its reduction in the pod;
* :func:`make_production_mesh`'s shape, coordinates and ``n_dp_shards``,
  its refusal without a process group, and the dry mesh's groups.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.launch.dist import spawn  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    dry_mesh, make_host_mesh, make_production_mesh, n_dp_shards,
)
from repro_torch.models.params import tree_leaves  # noqa: E402
from tests import test_torch_serve_mesh as sm  # noqa: E402
from tests import test_torch_tp as tp  # noqa: E402
from tests.test_torch_dist import (  # noqa: E402
    ATOL, LR, PARAM_LOOSE_SHARE, PARAM_LR_FRAC, RTOL, _close, _np,
)

TRAIN = {
    (2, 1, 1): [tp.case("dense", mode="dynamic")],
    (2, 2, 1): [tp.case("dense", mode="dynamic"), tp.case("moe", cfg="moe", mode="dynamic")],
    (2, 1, 2): [tp.case("dense", mode="dynamic"), tp.case("fsdp", mode="dynamic", smode="fsdp"),
                tp.case("moe-fsdp", cfg="moe", mode="dynamic", smode="fsdp")],
}
SERVE = {
    (2, 1, 1): [sm.case("s-dense", "dense")],
    (2, 2, 1): [sm.case("s-dense", "dense")],  # MoE routes over (pod, data) in TRAIN's cases
    (2, 1, 2): [sm.case("s-tp", "dense-qk"), sm.case("s-fsdp", "dense-qk", smode="fsdp")],
}


def pod_ranks(mesh, shapes, train_init, serve_init, out_dir):
    """One rank: on each (pod, data, model) mesh of ``shapes`` over this
    process group (the spawn's own first), the train cases, each with its
    collectives by group, then the serve cases (each writes
    ``<mesh>.<case>.<rank>.pt``), and this rank's coordinates."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import collectives

    for P, D, M in shapes:
        m = mesh if (P, D, M) == shapes[0] else make_host_mesh(D, M, device="cpu", pod=P)
        out = os.path.join(out_dir, f"{P}{D}{M}")
        os.makedirs(out, exist_ok=True)
        for c in TRAIN[(P, D, M)]:
            tp.tp_ranks(m, [c], train_init, out)
            torch.save(collectives.group_counts(),
                       os.path.join(out, f"{c['name']}.groups.{m.rank}.pt"))
        sm.serve_ranks(m, SERVE[(P, D, M)], serve_init, out)
        torch.save(m.coord, os.path.join(out, f"coord.{m.rank}.pt"))


def check_train(c, P, D, M, ranks, coords, groups_of_rank):
    """Metrics and the whole state against the JAX step on the global batch,
    the slices of two pods equal, and the pod's gradient all-reduce."""
    import jax

    name = c["name"]
    shards = P * D * (M if c["smode"] == "fsdp" else 1)
    groups = shards if c["cfg"] == "moe" else 1
    jm, jst = tp.jax_run(c["cfg"], groups, 1, c["mode"], 1, "none")
    r0 = ranks[0]
    for i, (t, j) in enumerate(zip(r0["metrics"], jm)):
        for k in ("loss", "ce", "aux", "grad_norm"):
            _close(t[k], j[k], f"{name} step {i} {k}")
        assert t["lr"] == pytest.approx(j["lr"], rel=1e-6, abs=1e-12)
    for r in ranks[1:]:
        assert r["metrics"] == r0["metrics"], name
    got = r0["whole"]
    for j, (x, y) in enumerate(zip(tree_leaves(got.params), jax.tree.leaves(jst.params))):
        x, y = _np(x), _np(y)
        np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL + PARAM_LR_FRAC * LR,
                                   err_msg=f"{name} params leaf {j}")
        assert (np.abs(x - y) > ATOL + RTOL * np.abs(y)).mean() <= PARAM_LOOSE_SHARE
    for what, a, b in (("m", got.opt.m, jst.opt.m), ("v", got.opt.v, jst.opt.v)):
        for j, (x, y) in enumerate(zip(tree_leaves(a), jax.tree.leaves(b))):
            _close(x, y, f"{name} {what} leaf {j}")
    # pod cuts no leaf: a rank's slices are bitwise those of its twin in pod 0
    for r, x in enumerate(ranks):
        co = coords[r]
        if co["pod"]:
            twin = ranks[r % (D * M)]
            for a, b in zip(tree_leaves(x["local"]), tree_leaves(twin["local"])):
                assert torch.equal(a, b), (name, r)
        shard = co["pod"] * D + co["data"]
        if c["smode"] == "fsdp":
            shard = shard * M + co["model"]
        n = x["rows"].stop - x["rows"].start
        assert x["rows"].start == shard * n and n * shards == tp.B, (name, r, x["rows"])
        # each gradient slice all-reduced over pod once a step, after the pod's reduction
        pod = groups_of_rank[r]["all_reduce"]["pod"]
        assert pod["calls"] == tp.STEPS * len(x["paths"]), (name, r, pod)
        assert pod["bytes"] == tp.STEPS * sum(t.numel() * t.element_size()
                                              for t in tree_leaves(x["local"])), (name, r)


# one spawn a world size: (2, 1, 1) on 2 ranks, (2, 2, 1) and (2, 1, 2) on 4
@pytest.mark.parametrize("shapes", [[(2, 1, 1)], [(2, 2, 1), (2, 1, 2)]])
def test_pod_axis_steps_match_jax_global_batch(shapes, tmp_path):
    train = [c for sh in shapes for c in TRAIN[sh]]
    serve = [c for sh in shapes for c in SERVE[sh]]
    tinit = tp.init_file(tmp_path, sorted({c["cfg"] for c in train}))
    sdir = tmp_path / "serve"
    sdir.mkdir()
    sinit = sm.init_file(sdir, serve)
    P, D, M = shapes[0]
    W = P * D * M
    spawn(pod_ranks, W, shapes, tinit, sinit, str(tmp_path), model=M, pod=P,
          device="cpu", timeout=600)
    for P, D, M in shapes:
        out = tmp_path / f"{P}{D}{M}"
        coords = [torch.load(out / f"coord.{r}.pt") for r in range(W)]
        assert [(c["pod"], c["data"], c["model"]) for c in coords] == [
            (p, d, m) for p in range(P) for d in range(D) for m in range(M)]
        for c in TRAIN[(P, D, M)]:
            ranks = [torch.load(out / f"{c['name']}.{r}.pt", weights_only=False)
                     for r in range(W)]
            groups = [torch.load(out / f"{c['name']}.groups.{r}.pt") for r in range(W)]
            check_train(c, P, D, M, ranks, coords, groups)
        for c in SERVE[(P, D, M)]:
            ranks = [torch.load(out / f"{c['name']}.{r}.pt", weights_only=False)
                     for r in range(W)]
            moe = sm.cfg_of(tbase, c["cfg"]).moe is not None
            sm.check_case(c, P * D if moe else 1, M if moe else 1, ranks)
            for x in ranks:  # a rank serves its (pod, data) rows
                assert x["rows"].stop - x["rows"].start == sm.B // (
                    P * D * (M if c["smode"] == "fsdp" else 1)), c["name"]


# ---------------------------------------------------------------------------
# the production meshes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("multi", [False, True])
def test_production_mesh_shape_coordinates_and_shards(multi):
    mesh = make_production_mesh(multi, dry=True)
    want = {"pod": 2, "data": 16, "model": 16} if multi else {"data": 16, "model": 16}
    assert mesh.shape == want and mesh.axis_names == tuple(want)
    assert n_dp_shards(mesh) == (32 if multi else 16)
    assert mesh.size == (512 if multi else 256) and mesh.device.type == "meta"
    assert mesh.rank == 0 and mesh.coords == (0, 0) and mesh.pod_coord == 0
    assert (mesh.comm.world, mesh.model_comm.world) == (16, 16)
    assert mesh.world_comm.world == mesh.size
    if multi:
        assert mesh.comm_of(("pod",)).world == 2
        assert mesh.comm_of(("pod", "data")).world == 32
        assert mesh.comm_of(("data", "model")).world == 256
    # ranks are placed model fastest, as jax.make_mesh places devices
    last = make_production_mesh(multi, dry=True, rank=mesh.size - 1)
    assert last.coord == {"pod": 1 if multi else 0, "data": 15, "model": 15}
    r = (1 * 16 + 3) * 16 + 5 if multi else 3 * 16 + 5
    one = make_production_mesh(multi, dry=True, rank=r)
    assert one.coord == {"pod": 1 if multi else 0, "data": 3, "model": 5}
    assert one.comm.rank == 3 and one.model_comm.rank == 5
    assert one.comm_of(("data", "model")).rank == 3 * 16 + 5
    if multi:
        assert one.comm_of(("pod", "data")).rank == 16 + 3


def test_production_mesh_refuses_without_its_process_group():
    with pytest.raises(RuntimeError, match="256 ranks"):
        make_production_mesh(False, device="cpu")
    with pytest.raises(RuntimeError, match="512 ranks"):
        make_production_mesh(True, device="cpu")


def test_mesh_without_pod_keeps_its_two_axes():
    mesh = make_host_mesh(device="cpu")
    assert mesh.axis_names == ("data", "model") and mesh.shape == {"data": 1, "model": 1}
    assert mesh.comm_of("world") is mesh.world_comm
    assert mesh.comm_of(("data", "model")) is mesh.world_comm
    one = make_host_mesh(device="cpu", pod=1)
    assert one.shape == {"pod": 1, "data": 1, "model": 1} and n_dp_shards(one) == 1
    dry = dry_mesh(None, 4, 2, rank=5)
    assert dry.coords == (2, 1) and dry.axis_names == ("data", "model")


def test_parallel_config_takes_the_pod_axis():
    par = tbase.ParallelConfig()
    par.check({"pod": 2, "data": 16, "model": 16})
    tbase.ParallelConfig(dp_axes=("pod", "data")).check({"pod": 2, "data": 2, "model": 1})
    with pytest.raises(NotImplementedError):
        tbase.ParallelConfig(dp_axes=("replica",)).check({"data": 2})
    with pytest.raises(NotImplementedError):
        par.check({"data": 2, "expert": 2})
    with pytest.raises(NotImplementedError):
        tbase.ParallelConfig(tp_axis="tensor").check({"data": 2, "model": 1})
