"""The port's serve engine against the JAX ``ServeEngine``, live, on the CPU.

Both engines serve the same seeded workload with the same weights (carried
across the bridge), the same engine geometry and the same step order
(arrivals, continuous admission with same-bucket batched prefill, one
decode round), both on the paged decode round (``use_paged_kernel=True``),
the JAX one on its interpret-mode Pallas page walk.  Their token streams
and first-token steps must be identical.  The dense round, chunked prefill
and prefix sharing are held against JAX in ``test_torch_serve_paths.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import reduced as jax_reduced  # noqa: E402
from repro.models.model import ExecFlags  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro.parallel.sharding import ShardingRules  # noqa: E402
from repro.serve.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serve.replicas import ReplicaSet  # noqa: E402
from repro.serve.request import WorkloadSpec as JaxWorkloadSpec  # noqa: E402
from repro.serve.request import build_workload as jax_build_workload  # noqa: E402

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.serve.engine import EngineConfig, ServeEngine  # noqa: E402
from repro_torch.serve.kvpool import PageAllocator, pages_needed  # noqa: E402
from repro_torch.serve.request import WorkloadSpec, build_workload  # noqa: E402
from repro_torch.serve.run import serve  # noqa: E402

RULES = ShardingRules(batch=(), embed=None, heads=None, kv_heads=None, mlp=None,
                      vocab=None, expert=None, ssm_inner=None)
FLAGS = ExecFlags(scan_layers=True, remat="none", attn_chunk=64)
GEOM = dict(max_slots=3, page_size=4, pages_per_slot=8, max_prefills_per_step=2)
SPEC = dict(n_requests=8, vocab_size=512, seed=3, mean_interarrival_steps=1.0,
            prompt_len=(3, 20), new_tokens=(3, 10))


@pytest.fixture(scope="module")
def jax_run():
    cfg = jax_reduced(jax_get_config("qwen3-0.6b"), dtype="float32", n_kv_heads=2)
    params = jax_init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    ecfg = JaxEngineConfig(**GEOM, use_paged_kernel=True, kernel_interpret=True)
    rset = ReplicaSet(cfg, params, RULES, FLAGS, ecfg, n_replicas=1, snapshots=False)
    res = rset.run(jax_build_workload(JaxWorkloadSpec(**SPEC)))
    return jax.tree.map(np.asarray, params), res


@pytest.fixture(scope="module")
def port_setup(jax_run):
    cfg = reduced(get_config("qwen3-0.6b"), dtype="float32", n_kv_heads=2)
    return cfg, params_from_numpy(jax_run[0], cfg, device="cpu")


def _port_serve(port_setup, alloc_rng=None):
    cfg, params = port_setup
    eng = ServeEngine(cfg, params, EngineConfig(**GEOM, use_paged_kernel=True), device="cpu",
                      alloc_rng=alloc_rng)
    return eng, serve(eng, build_workload(WorkloadSpec(**SPEC)))


def test_token_streams_identical_to_jax_engine(jax_run, port_setup):
    jres = jax_run[1]
    eng, res = _port_serve(port_setup)
    assert res.streams() == jres.streams()
    for rid, rs in res.states.items():
        js = jres.states[rid]
        assert rs.done and len(rs.emitted) == rs.req.max_new_tokens
        assert (rs.first_token_step, rs.last_token_step) == (
            js.first_token_step, js.last_token_step)
    assert res.n_steps == jres.n_steps
    assert eng.n_active == 0 and eng.alloc.free_count == eng.ecfg.resolved_n_pages - 1


def test_token_streams_invariant_to_page_layout(jax_run, port_setup):
    _, res = _port_serve(port_setup, alloc_rng=np.random.default_rng(9))
    assert res.streams() == jax_run[1].streams()


def test_summary_counts_every_token(port_setup):
    _, res = _port_serve(port_setup)
    s = res.summary()
    assert s["n_completed"] == s["n_requests"] == SPEC["n_requests"]
    assert s["n_tokens"] == sum(len(v) for v in res.streams().values())
    assert s["ttft_steps"]["mean"] >= 0 and s["tpot_ms"]["mean"] > 0


@pytest.mark.parametrize("spec", [
    SPEC,
    dict(SPEC, arrival="bursty", length_dist="longtail", shared_prefix=8,
         n_prefix_groups=2, priority_classes=((0, 1.0, 0), (1, 0.5, 40))),
])
def test_workload_copy_matches_jax(spec):
    ours = [dataclasses.astuple(r) for r in build_workload(WorkloadSpec(**spec))]
    theirs = [dataclasses.astuple(r) for r in jax_build_workload(JaxWorkloadSpec(**spec))]
    assert ours == theirs and len(ours) == spec["n_requests"]


def test_page_allocator_reserves_and_frees():
    alloc = PageAllocator(9, 4, rng=np.random.default_rng(0))
    assert alloc.ensure("a", 10) and len(alloc.tables["a"]) == pages_needed(10, 4) == 3
    assert alloc.ensure("a", 12) == []
    assert not alloc.can_allocate("b", 25)
    row = alloc.table_row("a", 5)
    assert row[3:] == [0, 0] and 0 not in row[:3]
    assert sorted(alloc.free("a")) == sorted(row[:3]) and alloc.free_count == 8
    with pytest.raises(MemoryError):
        alloc.ensure("c", 40)


def test_engine_rejects_oversized_request(port_setup):
    cfg, params = port_setup
    eng = ServeEngine(cfg, params, EngineConfig(**GEOM, use_paged_kernel=True), device="cpu")
    from repro_torch.serve.request import Request, RequestState

    with pytest.raises(ValueError, match="max_len"):
        eng.try_bind(RequestState(Request(0, 0, tuple(range(30)), 8)), 0)
