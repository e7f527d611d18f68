"""The prefill and decode steps of the SSM families with the mixer cut over
the ``model`` axis, against the live JAX steps on the global batch, on the
CPU.

One spawn of gloo ranks a mesh shape runs ``make_prefill_step(...,
mesh=...)`` on a prompt batch, then NEW greedy ``make_decode_step`` steps,
each rank feeding back the ids ``greedy_token`` gives on its vocabulary
columns: tiny-ssm at (1, 2) and (2, 2), tiny-hybrid at (1, 2)
(``tests/test_torch_tp_ssm.py``'s configs), against the one-device JAX
``make_prefill_step`` / ``make_decode_step`` (``forward_prefill`` /
``forward_decode``) with ``ExecFlags(n_dp_shards=D)``:

* every decode step's ids are the JAX step's own;
* logits and caches at ``tests/test_torch_serve_mesh.py``'s rtol 1e-5 with
  its SSM absolute term (1e-4 of the tensor's largest magnitude,
  ``tests/test_torch_ssm.py``'s on prefill and decode): a rank's rows, its
  vocabulary columns, the KV heads its query heads read, its SSD heads
  and its conv window's channels ``[x_m | B | C]``;
* each param slice has the layout's local shape, and the serve specs mark
  the SSM caches cut over ``model``;
* the cut mixer's all-reduces of a prefill and of the decode steps carry
  exactly the bytes the shapes give: ``tp:ssm_out`` (rows, positions, d)
  f32 and ``tp:gate_norm`` (rows, positions) f32 a layer.
"""
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.launch.dist import spawn  # noqa: E402
from repro_torch.launch.state import local_params  # noqa: E402
from repro_torch.launch.steps import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.models.kvcache import held_kv_heads, held_ssm_heads  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.parallel import collectives  # noqa: E402
from repro_torch.serve.sampling import greedy_token  # noqa: E402
from tests.test_torch_serve_mesh import SSM_ATOL, close, kv_index  # noqa: E402
from tests.test_torch_tp_ssm import _cfg  # noqa: E402

B, S, NEW = 4, 16, 8
CASES = {(1, 2): ["ssm", "hybrid"], (2, 2): ["ssm"]}


def serve_ranks(mesh, names, init_path, out_dir):
    """One rank: each config's prefill and NEW greedy decode steps; writes
    ``<config>.<rank>.pt``."""
    inits = torch.load(init_path, weights_only=False)
    L = S + NEW
    for name in names:
        cfg = _cfg(tbase, name)
        par = tbase.ParallelConfig()
        pstep, specs = make_prefill_step(cfg, par, mesh, tbase.ShapeConfig("p", S, B, "prefill"),
                                         max_len=L)
        dstep, _ = make_decode_step(cfg, par, mesh, tbase.ShapeConfig("d", L, B, "decode"))
        params = local_params(inits[name]["params"], pstep.layout)
        collectives.reset_counts()
        caches, logits = pstep(params, inits[name]["batch"])
        pre_counts = collectives.counts()
        pre_caches = [{k: v.clone() for k, v in e.items()} for e in caches]
        tp = pstep.model_axis
        toks, all_logits = [], [logits]
        tok = greedy_token(logits, cfg, tp)
        collectives.reset_counts()
        for i in range(NEW):
            toks.append(tok)
            caches, logits = dstep(params, caches, tok, S + i)
            all_logits.append(logits)
            tok = greedy_token(logits, cfg, dstep.model_axis)
        toks.append(tok)
        lay = pstep.layout
        torch.save({"logits": all_logits, "toks": toks, "pre_caches": pre_caches,
                    "caches": caches, "rows": pstep.rows, "coords": mesh.coords,
                    "axis": dict(size=tp.size, rank=tp.rank, heads=tp.heads, kv=tp.kv,
                                 vocab=tp.vocab, ssm=tp.ssm),
                    "kv_heads": held_kv_heads(cfg, tp), "ssm_heads": held_ssm_heads(cfg, tp),
                    "shapes": [(tuple(x.shape), lay.local_shape(k))
                               for k, x in enumerate(tree_leaves(params))],
                    "pre_counts": pre_counts, "dec_counts": collectives.counts(),
                    "held_caches": [{k: tuple(v) for k, v in e.items()}
                                    for e in specs["held_caches"]]},
                   os.path.join(out_dir, f"{name}.{mesh.rank}.pt"))


# ---------------------------------------------------------------------------
# the JAX side (imported in the test process only)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def jax_params(name):
    import jax
    import jax.numpy as jnp

    from repro.configs import base as jbase
    from repro.models import params as jparams

    return jparams.init_params(_cfg(jbase, name), jax.random.PRNGKey(0), jnp.float32)


def batch_of(name):
    return {"tokens": np.random.default_rng(7).integers(
        0, _cfg(tbase, name).vocab_size, size=(B, S), dtype=np.int32)}


@functools.lru_cache(maxsize=None)
def jax_run(name, groups):
    """The JAX prefill step, then NEW greedy decode steps: per step the
    logits and ids, the caches after the prefill and at the end."""
    import jax
    import jax.numpy as jnp

    from repro.configs import base as jbase
    from repro.launch.mesh import make_host_mesh
    from repro.launch.steps import make_decode_step as jdecode
    from repro.launch.steps import make_prefill_step as jprefill
    from repro.models import model as jmodel
    from repro.serve.sampling import greedy_token as jgreedy

    jcfg = _cfg(jbase, name)
    L = S + NEW
    flags = jmodel.ExecFlags(remat="none", attn_chunk=S, n_dp_shards=groups)
    mesh = make_host_mesh()
    par = jbase.ParallelConfig(fsdp=False)
    with mesh:
        pre, *_ = jprefill(jcfg, par, mesh, jbase.ShapeConfig("p", S, B, "prefill"),
                           flags=flags, max_len=L)
        dec, *_ = jdecode(jcfg, par, mesh, jbase.ShapeConfig("d", L, B, "decode"), flags=flags)
        caches, logits = pre(jax_params(name), jax.tree.map(jnp.asarray, batch_of(name)))
    pre_caches = jax.tree.map(np.asarray, caches)
    out_logits, toks = [np.asarray(logits)], []
    tok = jgreedy(logits, jcfg)
    for i in range(NEW):
        toks.append(np.asarray(tok))
        with mesh:
            caches, logits = dec(jax_params(name), caches, tok, jnp.int32(S + i))
        out_logits.append(np.asarray(logits))
        tok = jgreedy(logits, jcfg)
    toks.append(np.asarray(tok))
    return out_logits, toks, pre_caches, jax.tree.map(np.asarray, caches)


def init_file(tmp_path, names) -> str:
    import jax

    from repro_torch.bridge import params_from_numpy

    path = str(tmp_path / "init.pt")
    torch.save({n: {"params": params_from_numpy(jax.tree.map(np.asarray, jax_params(n)),
                                                _cfg(tbase, n), device="cpu"),
                    "batch": batch_of(n)} for n in names}, path)
    return path


def held_part(cfg, axis, key, want):
    """The part of a JAX cache leaf a rank holds: its KV heads; its SSD
    heads; its conv channels ``[x_m | B | C]``."""
    if key in ("k", "v"):
        return want[:, :, :, kv_index(cfg, axis)]
    if not axis["ssm"]:
        return want
    M, m = axis["size"], axis["rank"]
    if key == "ssd":
        return np.split(want, M, axis=2)[m]
    d_inner = cfg.ssm.expand * cfg.d_model
    q = d_inner // M
    return np.concatenate([want[..., m * q:(m + 1) * q], want[..., d_inner:]], axis=-1)


def check_rank(name, cfg, x, D):
    jl, jt, jpre, jend = jax_run(name, D)
    rows = x["rows"]
    axis = x["axis"]
    assert axis["ssm"], name
    for i, (t, j) in enumerate(zip(x["toks"], jt)):
        assert np.array_equal(t.numpy(), j[rows]), (name, i, t, j[rows])
    for i, (t, j) in enumerate(zip(x["logits"], jl)):
        j = j[rows]
        if t.shape[-1] != j.shape[-1]:  # this rank's vocabulary columns
            V = t.shape[-1]
            j = j[:, axis["rank"] * V:(axis["rank"] + 1) * V]
        close(t, j, f"{name} logits {i}", SSM_ATOL)
    nh = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
    assert x["ssm_heads"] == nh // axis["size"], name
    for what, got, want in (("prefill", x["pre_caches"], jpre), ("end", x["caches"], jend)):
        for p, (te, je) in enumerate(zip(got, want)):
            for k in te:
                w = held_part(cfg, axis, k, je[k][:, rows])
                assert tuple(te[k].shape) == w.shape, (name, what, k)
                close(te[k], w, f"{name} {what} cache {p}.{k}", SSM_ATOL)
    for held, local in x["shapes"]:
        assert held == local, name
    for e in x["held_caches"]:
        if "ssd" in e:
            assert e["ssd"][2] == "model" and e["conv"][3] == "model", name


def check_bytes(cfg, x):
    """The cut mixer's all-reduce bytes (the module docstring)."""
    rows = x["rows"].stop - x["rows"].start
    n_ssm = sum(cfg.layer_kind(i) == "ssm" for i in range(cfg.n_layers))
    for counts, seq, steps in ((x["pre_counts"], S, 1), (x["dec_counts"], 1, NEW)):
        ar = counts["all_reduce"]
        assert ar["tp:ssm_out"]["bytes"] == n_ssm * rows * seq * cfg.d_model * 4 * steps
        assert ar["tp:gate_norm"]["bytes"] == n_ssm * rows * seq * 4 * steps


@pytest.mark.parametrize("D,M", [(1, 2), (2, 2)])
def test_ssm_serve_steps_on_the_model_axis_match_jax(D, M, tmp_path):
    names = CASES[(D, M)]
    init_path = init_file(tmp_path, names)
    spawn(serve_ranks, D * M, names, init_path, str(tmp_path), model=M, device="cpu",
          timeout=600)
    for name in names:
        cfg = _cfg(tbase, name)
        for r in range(D * M):
            x = torch.load(tmp_path / f"{name}.{r}.pt", weights_only=False)
            check_rank(name, cfg, x, D)
            check_bytes(cfg, x)
