"""The port's model against the JAX package's, live, on the CPU.

The JAX weights cross through ``repro_torch.bridge``; tokens come from a
numpy seed.  The config is ``reduced(qwen3-0.6b, dtype=float32,
n_kv_heads=2)``: plain ``reduced`` gives n_kv_heads == n_heads, which would
leave GQA (G = 2 in the real model) untested.

Tolerance 1e-4 on f32 logits: both sides compute the same f32 arithmetic,
but the port's attention is the flash kernel's plain version (scores and
PV in f32) where JAX's prefill runs ``causal_attention``, and the two sum in
different orders, as do torch's and XLA's matmuls; the differences are a
few f32 ulps per layer on logits of order 1, well under 1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import reduced as jax_reduced  # noqa: E402
from repro.models import params as jparams  # noqa: E402
from repro.models.kvcache import cache_structs as jax_cache_structs  # noqa: E402
from repro.models.model import ExecFlags  # noqa: E402
from repro.models.model import forward_decode as jax_forward_decode  # noqa: E402
from repro.models.model import forward_prefill as jax_forward_prefill  # noqa: E402
from repro.parallel.sharding import ShardingRules  # noqa: E402
from repro.serve.kvpool import init_pool as jax_init_pool  # noqa: E402
from repro.serve.kvpool import scatter_prefill as jax_scatter_prefill  # noqa: E402

from repro_torch.bridge import params_from_numpy, params_to_numpy, tensor_from_numpy  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.models import params as tparams  # noqa: E402
from repro_torch.models.kvcache import cache_structs  # noqa: E402
from repro_torch.models.model import forward_decode, forward_prefill  # noqa: E402
from repro_torch.serve.kvpool import init_pool, scatter_prefill  # noqa: E402

RULES = ShardingRules(batch=(), embed=None, heads=None, kv_heads=None, mlp=None,
                      vocab=None, expert=None, ssm_inner=None)
FLAGS = ExecFlags(scan_layers=True, remat="none", attn_chunk=64)
TOL = 1e-4


def _cfgs():
    return (jax_reduced(jax_get_config("qwen3-0.6b"), dtype="float32", n_kv_heads=2),
            reduced(get_config("qwen3-0.6b"), dtype="float32", n_kv_heads=2))


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    jp = jparams.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and tree and not isinstance(tree[0], int):
        return tuple(_shapes(v) for v in tree)
    return tuple(tree.shape) if hasattr(tree, "shape") else tuple(tree)


@pytest.mark.parametrize("name", ["qwen3-0.6b", "llama-350m"])
def test_param_shapes_match_jax(name):
    want = jax.tree.map(lambda e: e[0], jparams.param_shapes(jax_get_config(name)),
                        is_leaf=jparams._is_entry)
    assert _shapes(tparams.param_shapes(get_config(name))) == _shapes(want)


def test_configs_match_jax():
    import dataclasses

    for name in ("qwen3-0.6b", "llama-350m", "llama-1b", "llama-7b"):
        j, t = jax_get_config(name), get_config(name)
        jd = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
        td = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
        assert jd == td, name
    jcfg, tcfg = _cfgs()
    assert (tcfg.n_heads, tcfg.n_kv_heads, tcfg.resolved_head_dim) == (4, 2, 32)
    assert jcfg.resolved_head_dim == tcfg.resolved_head_dim


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_is_bitwise(dtype):
    jcfg, tcfg = _cfgs()
    jp = jax.tree.map(np.asarray, jparams.init_params(jcfg, jax.random.PRNGKey(1),
                                                       jnp.dtype(dtype)))
    tp = params_from_numpy(jp, tcfg, device="cpu")
    assert tp["embed"].dtype == getattr(torch, dtype)
    back = params_to_numpy(tp)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


def test_bridge_rejects_wrong_shapes(model):
    jcfg, tcfg, jp, _ = model
    tree = jax.tree.map(np.asarray, jp)
    tree["final_norm"] = np.ones(7, np.float32)
    with pytest.raises(ValueError, match="final_norm"):
        params_from_numpy(tree, tcfg, device="cpu")


def test_init_params_follows_init_leaf():
    _, tcfg = _cfgs()
    a = tparams.init_params(tcfg, torch.Generator().manual_seed(5), device="cpu")
    b = tparams.init_params(tcfg, torch.Generator().manual_seed(5), device="cpu")
    assert _shapes(a) == _shapes(tparams.param_shapes(tcfg))
    assert torch.equal(a["embed"], b["embed"])
    assert torch.equal(a["final_norm"], torch.ones(tcfg.d_model))
    mixer = a["layers"][0]["mixer"]
    assert torch.equal(mixer["q_norm"], torch.ones_like(mixer["q_norm"]))
    assert abs(float(a["embed"].std()) - 0.02) < 2e-3
    assert abs(float(mixer["wq"].std()) - tcfg.d_model ** -0.5) < 0.01
    bf = tparams.init_params(tcfg, torch.Generator().manual_seed(5), device="cpu",
                             dtype=torch.bfloat16)
    assert bf["embed"].dtype == torch.bfloat16


def _prefill_inputs(vocab, seed=0):
    rng = np.random.default_rng(seed)
    lens = np.array([16, 10, 3])
    toks = np.zeros((3, 16), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, vocab, n)
    return toks, (lens - 1).astype(np.int32)


def test_forward_prefill_matches_jax(model):
    jcfg, tcfg, jp, tp = model
    toks, last = _prefill_inputs(tcfg.vocab_size)
    jcaches, jlogits = jax_forward_prefill(
        jp, {"tokens": jnp.asarray(toks)}, jcfg, RULES, FLAGS,
        jax_cache_structs(jcfg, 3, 16, jnp.float32), logit_pos=jnp.asarray(last))
    tcaches, tlogits = forward_prefill(
        tp, {"tokens": torch.from_numpy(toks)}, tcfg, cache_structs(tcfg, 3, 16),
        logit_pos=torch.from_numpy(last))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=TOL, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcaches[0][name].numpy(), np.asarray(jcaches[0][name]),
                                   atol=TOL, rtol=0)


def test_forward_decode_paged_matches_jax(model):
    """Prefill into pages of a shuffled pool, then two paged decode steps
    with ragged lengths and a null lane, on both sides."""
    jcfg, tcfg, jp, tp = model
    ps, P, n_pages = 4, 6, 24
    toks, last = _prefill_inputs(tcfg.vocab_size, seed=1)
    lens = last + 1
    rng = np.random.default_rng(2)
    perm = rng.permutation(np.arange(1, n_pages))
    tables = np.zeros((4, P), np.int32)  # slot 3 stays a null lane
    page_ids = np.zeros((3, 4), np.int32)
    for i in range(3):
        tables[i] = perm[i * P:(i + 1) * P]
        page_ids[i] = tables[i, :4]

    jdense, _ = jax_forward_prefill(
        jp, {"tokens": jnp.asarray(toks)}, jcfg, RULES, FLAGS,
        jax_cache_structs(jcfg, 3, 16, jnp.float32), logit_pos=jnp.asarray(last))
    jpool = jax_scatter_prefill(jax_init_pool(jcfg, n_pages, ps, jnp.float32), jdense,
                                jnp.asarray(page_ids), page_size=ps)
    tdense, _ = forward_prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                                cache_structs(tcfg, 3, 16),
                                logit_pos=torch.from_numpy(last))
    tpool = scatter_prefill(init_pool(tcfg, n_pages, ps, torch.float32, "cpu"), tdense,
                            torch.from_numpy(page_ids), page_size=ps)

    cur = np.concatenate([lens, [0]]).astype(np.int32)
    for step in range(2):
        tok = rng.integers(0, tcfg.vocab_size, 4).astype(np.int32)
        jpool, jlogits = jax_forward_decode(
            jp, jpool, jnp.asarray(tok), jnp.asarray(cur), jcfg, RULES, FLAGS,
            page_tables=jnp.asarray(tables), page_size=ps, kernel_impl="pallas-interpret")
        tpool, tlogits = forward_decode(
            tp, tpool, torch.from_numpy(tok), torch.from_numpy(cur.copy()), tcfg,
            page_tables=torch.from_numpy(tables), page_size=ps)
        live = cur > 0
        np.testing.assert_allclose(tlogits.numpy()[live], np.asarray(jlogits)[live],
                                   atol=TOL, rtol=0)
        cur = cur + live.astype(np.int32)
    live_pages = np.unique(tables[:3])
    for name in ("k", "v"):
        np.testing.assert_allclose(
            tpool[0][name].numpy()[:, live_pages], np.asarray(jpool[0][name])[:, live_pages],
            atol=TOL, rtol=0)


def test_bf16_model_runs_on_cpu(model):
    """The bf16 path runs end to end on the CPU and stays near the f32
    path (bf16 keeps ~3 significant digits)."""
    _, tcfg, _, tp = model
    from repro_torch.models.params import map_leaves

    tp16 = map_leaves(lambda _n, t: t.to(torch.bfloat16), tp)
    toks, last = _prefill_inputs(tcfg.vocab_size)
    _, l32 = forward_prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                             cache_structs(tcfg, 3, 16), logit_pos=torch.from_numpy(last))
    _, l16 = forward_prefill(tp16, {"tokens": torch.from_numpy(toks)}, tcfg,
                             cache_structs(tcfg, 3, 16, torch.bfloat16),
                             logit_pos=torch.from_numpy(last))
    assert l16.dtype == torch.float32
    assert float((l16 - l32).abs().max()) < 0.05 * float(l32.abs().max())


def test_tensor_from_numpy_bf16_bits():
    import ml_dtypes

    a = np.array([1.0, -2.5, 3.140625], dtype=ml_dtypes.bfloat16)
    t = tensor_from_numpy(a, "cpu")
    assert t.dtype == torch.bfloat16
    assert t.float().tolist() == [1.0, -2.5, 3.140625]
