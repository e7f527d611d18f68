"""The tiny-moe cases of ``tests/test_torch_dist.py``: the port's
data-parallel step on W = 2 and W = 4 gloo ranks against the live JAX step
on the global batch with ``ExecFlags(n_dp_shards=W)`` (each rank's rows
are the reference's routing group r), and the port's one-process
``n_dp_shards = 2`` MoE loss and gradients against JAX's, at a capacity
factor that drops tokens differently in two groups than in one.
Tolerances and checks as in ``tests/test_torch_dist.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.models.model import ExecFlags  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from tests.test_torch_dist import S, TINY, _cfg, _close, _jax_init, mesh_case  # noqa: E402


@pytest.mark.parametrize("W", [2, 4])
def test_moe_mesh_step_matches_jax_global_batch(W, tmp_path):
    mesh_case("moe", W, tmp_path)


def test_one_process_moe_groups_match_jax(local_rules):
    """``ExecFlags(n_dp_shards=2)`` on one process: loss and every gradient
    leaf against JAX's ``forward_loss`` with the same flag, at capacity
    factor 1, where two groups drop other tokens than one."""
    import jax

    from repro.configs import base as jbase
    from repro.core.ndb import NDBContext as JCtx
    from repro.models import model as jmodel
    from repro_torch.bridge import state_from_numpy
    from repro_torch.core.ndb import NDBContext
    from repro_torch.launch.steps import loss_and_grads

    moe = dict(TINY["moe"]["moe"], capacity_factor=1.0)
    jcfg, tcfg = _cfg(jbase, "moe", moe=moe), _cfg(tbase, "moe", moe=moe)
    jst = _jax_init("moe")
    tst = state_from_numpy(jax.tree.map(np.asarray, jst), tcfg, device="cpu")
    batch = SyntheticLM(tcfg.vocab_size).batch(0, 4, S)
    out = {}
    for groups in (1, 2):
        jflags = jmodel.ExecFlags(remat="none", attn_chunk=S, ce_chunk=16, n_dp_shards=groups)

        def loss(p):
            return jmodel.forward_loss(p, jst.proj, batch, jcfg, local_rules,
                                       JCtx(mode="off", mecefo=jbase.MeCeFOConfig()), jflags)

        (jl, _), jg = jax.value_and_grad(loss, has_aux=True)(jst.params)
        tl, tm, tg = loss_and_grads(
            tst.params, tst.proj, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg,
            NDBContext(mode="off", mecefo=tbase.MeCeFOConfig()),
            ExecFlags(remat="none", ce_chunk=16, n_dp_shards=groups))
        _close(tl, jl, f"{groups} groups loss")
        for j, (a, b) in enumerate(zip(tree_leaves(tg), jax.tree.leaves(jg))):
            _close(a, b, f"{groups} groups grad leaf {j}")
        out[groups] = float(tl)
    assert out[1] != out[2]  # the grouping changes which tokens drop
