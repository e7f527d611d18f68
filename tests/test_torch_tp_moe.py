"""Expert parallelism over the ``model`` axis against the live JAX step on
the global batch, on the CPU (the MoE cases of ``tests/test_torch_tp.py``,
a second file so the two run on separate test workers).

tiny-moe (8 experts, top 2) at capacity factor 1, where the routing groups
decide which tokens drop, on meshes (1, 2) and (1, 4):

* ``sharding_mode="tp_fsdp"``: the model ranks hold the same tokens, each
  runs its E/M experts on the whole dispatch buffer and the outputs are
  gathered along E before the combine; attention and vocabulary are
  tensor-parallel; the JAX step routes in one group;
* ``sharding_mode="fsdp"``: the batch is cut over every rank, the experts'
  places cross the model group all-to-all; the JAX step routes in D·M
  groups (``ExecFlags(n_dp_shards=D·M)``), each rank's rows being group
  ``d·M + m``;

each in ``off``, ``dynamic``, ``degraded`` and ``degraded_sync``, with the
checks of ``tests/test_torch_tp.py`` (the whole state at
``tests/test_torch_dist.py``'s tolerances, bitwise whole leaves, exact
1/M expert slices) and the expert collectives reached: ``ep:split`` and
``ep:gather`` under ``tp_fsdp``, ``ep:a2a`` under ``fsdp``, where the
expert leaves' gradients sum over the data group only.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.launch.dist import spawn  # noqa: E402
from tests.test_torch_tp import _cfg, case, check_case, init_file, tags, tp_ranks  # noqa: E402

MODES = (("off", False), ("dynamic", False), ("degraded", False), ("degraded", True))
CASES = [case(f"{smode}-{m}{'-sync' if sync else ''}", cfg="moe", mode=m, sync=sync, smode=smode)
         for smode in ("tp_fsdp", "fsdp") for m, sync in MODES]


@pytest.mark.parametrize("M", [2, 4])
def test_expert_parallel_step_matches_jax_global_batch(M, tmp_path):
    init_path = init_file(tmp_path, ["moe"])
    spawn(tp_ranks, M, CASES, init_path, str(tmp_path), model=M, device="cpu", timeout=600)
    cfg = _cfg(tbase, "moe")
    for c in CASES:
        ranks = [torch.load(tmp_path / f"{c['name']}.{r}.pt", weights_only=False)
                 for r in range(M)]
        r0 = check_case(c, 1, M, ranks)
        counts = r0["counts"]
        experts = [k for k, p in enumerate(r0["paths"]) if p.split(".")[-1] in
                   ("w_up", "w_gate", "w_down") and ".ffn." in p]
        assert experts and all(r0["mdims"][k] == 1 for k in experts), c["name"]
        if c["smode"] == "fsdp":
            assert counts["all_to_all"]["ep:a2a"]["calls"] > 0, c["name"]
            assert not {"ep:gather", "ep:split"} & tags(counts, "all_gather"), c["name"]
            # an expert leaf's gradient sums over the data group, the rest over all
            grads = {t for k in ("all_reduce", "reduce_scatter") for t in tags(counts, k)
                     if t.startswith("grad:")}
            assert grads, c["name"]
        else:
            assert {"ep:gather", "ep:split"} <= tags(counts, "all_gather"), c["name"]
            assert "all_to_all" not in counts, c["name"]
            assert {"tp:embed", "tp:attn_out"} <= tags(counts, "all_reduce"), c["name"]
        if c["sync"]:
            lowrank = {t for t in tags(counts, "all_reduce") if t.startswith("lowrank:")}
            assert lowrank == {"lowrank:" + r0["paths"][k] for k in experts}, c["name"]
    assert cfg.moe.capacity_factor == 1.0
