"""The port's prefill and decode steps over a (data, model) mesh against the
live JAX steps on the global batch, on the CPU.

Each mesh shape is one spawn of gloo ranks (``launch/dist.py:spawn`` with
``device="cpu"``) that runs every case of that shape:
``make_prefill_step(..., mesh=...)`` on a prompt batch, then 8 greedy
``make_decode_step`` steps, each rank feeding back the ids
``serve/sampling.py:greedy_token`` gives on its own logits (its vocabulary
columns under the model axis).  The ranks write their logits, caches,
ids, held param slices and collective counters; the test holds them
against the one-device JAX ``make_prefill_step`` / ``make_decode_step``
on ``make_host_mesh()`` over the global batch, with
``ExecFlags(n_dp_shards=G)`` at the port's MoE group count (D, or D·M
under ``sharding_mode="fsdp"``):

* every decode step's ids are the JAX step's own (``jnp.argmax``);
* logits and caches at rtol 1e-5, with an absolute term of 1e-5 of the
  tensor's largest magnitude: a rank's rows, its vocabulary columns and
  its KV heads (KV/M where the axis cuts them, ``local_kv``'s where it does
  not).  The absolute term scales because torch's and XLA's f32 products
  sum in other orders: one product's elements differ by ~10 ulps of its
  largest terms, and over 4 layers and 8 steps a few logits and cache
  elements differ by up to ~1.3e-6 of the tensor's scale (4.2e-6 where a
  cache reaches 3.2), so an absolute 1e-6 would fail on noise alone.  The
  SSM case takes ``tests/test_torch_ssm.py``'s absolute 1e-4 on prefill
  and decode, set by the SSD scan's f32 decays;
* a param slice is exactly its share of the whole leaf;
* the model axis's all-reduces of a prefill and of a decode step (the
  embedding's, each layer's attention and FFN outputs) carry exactly the
  bytes the shapes give.

Cases: tiny-dense with qk-norm at (1, 2) (the KV heads cut), (1, 4) (2 KV
heads: each rank's one query head reads a shared one) and tiny-dense at
(2, 2) (with FSDP); at (1, 2) also a padded tied vocabulary, sequence
parallelism in the prefill, the 2-D ``sharding_mode="fsdp"`` and the
vision and audio frontends (reduced phi-3-vision and musicgen in f32); at
(2, 2) also reduced mamba2-2.7b on each data group's (2, 1) mesh, its
conv and SSD caches cut over ``data``.  The MoE cases are in
``tests/test_torch_serve_mesh_moe.py`` (a second file, so its spawn runs
on another test worker).  Also the unit checks: ``input_specs`` for
prefill and decode and ``cache_annotations`` against the JAX package's
for every registered config, glm4-9b's ``cache_hd`` cut at M = 4 beside
the port's ``local_kv`` heads, ``greedy_token`` over a vocabulary cut on
ties, and the SSM refusal at M = 2.
"""
import functools
import os
import threading
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.launch.dist import spawn  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.launch.state import local_params  # noqa: E402
from repro_torch.launch.steps import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.models.kvcache import held_kv_heads  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.parallel import collectives  # noqa: E402
from repro_torch.parallel.collectives import Comm  # noqa: E402
from repro_torch.serve.sampling import greedy_token  # noqa: E402
from tests.test_torch_dist import TINY  # noqa: E402

RTOL = 1e-5
B, S, NEW = 4, 16, 8
SSM_S = 32  # one SSD chunk of the reduced config
SSM_ATOL = 1e-4  # tests/test_torch_ssm.py's on SSM prefill and decode (the scan's f32 decays)
CFGS = {
    "dense": TINY["dense"],
    "dense-qk": dict(TINY["dense"], qk_norm=True),
    "dense-pad": dict(TINY["dense"], vocab_size=250, tie_embeddings=True),
}
REDUCED = {"vision": "phi-3-vision-4.2b", "audio": "musicgen-medium", "ssm": "mamba2-2.7b",
           "moe": "qwen3-moe-30b-a3b"}


def case(name, cfg, sp=False, smode="tp_fsdp", fsdp=True, data_mesh=False):
    return dict(name=name, cfg=cfg, sp=sp, smode=smode, fsdp=fsdp, data_mesh=data_mesh)


CASES = {
    (1, 2): [case("kv-cut", "dense-qk"), case("pad-tied", "dense-pad"),
             case("sp", "dense-qk", sp=True), case("fsdp-2d", "dense-qk", smode="fsdp"),
             case("vision", "vision"), case("audio", "audio")],
    (1, 4): [case("local-kv", "dense-qk")],
    (2, 2): [case("tp-fsdp", "dense"), case("ssm-data", "ssm", data_mesh=True)],
}


def cfg_of(pkg, name):
    if name in REDUCED:
        kw = {"capacity_factor": 1.0} if name == "moe" else {}
        cfg = pkg.reduced(pkg.get_config(REDUCED[name]), dtype="float32")
        if kw:
            import dataclasses

            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **kw))
        return cfg
    fields = dict(CFGS[name])
    if "moe" in fields:
        fields["moe"] = pkg.MoEConfig(**fields["moe"])
    return pkg.ModelConfig(**fields)


def seq_of(c):
    return SSM_S if c["cfg"] == "ssm" else S


def parallel_of(c):
    return tbase.ParallelConfig(fsdp=c["fsdp"], sharding_mode=c["smode"],
                                sequence_parallel=c["sp"])


def groups_of(c, D, M):
    """The MoE routing groups of the global batch: the batch's shards."""
    if c["data_mesh"]:
        return D
    return D * M if c["smode"] == "fsdp" else D


def data_mesh(mesh) -> Mesh:
    """This rank's data group as a (D, 1) mesh of its own."""
    return Mesh({"data": mesh.sizes[0], "model": 1}, mesh.comm.rank,
                {("data",): mesh.comm, ("model",): Comm(None, mesh.device, 0, 1),
                 ("data", "model"): mesh.comm})


def serve_ranks(mesh, cases, init_path, out_dir):
    """One rank: every case's prefill and NEW greedy decode steps; writes
    ``<case>.<rank>.pt``."""
    inits = torch.load(init_path, weights_only=False)
    for c in cases:
        cfg = cfg_of(tbase, c["cfg"])
        init = inits[c["cfg"]]
        m = data_mesh(mesh) if c["data_mesh"] else mesh
        S_ = seq_of(c)
        L = S_ + NEW
        par = parallel_of(c)
        pstep, specs = make_prefill_step(cfg, par, m, tbase.ShapeConfig("p", S_, B, "prefill"),
                                         max_len=L)
        dstep, _ = make_decode_step(cfg, par, m, tbase.ShapeConfig("d", L, B, "decode"))
        params = local_params(init["params"], pstep.layout)
        collectives.reset_counts()
        caches, logits = pstep(params, init["batch"])
        pre_counts = collectives.counts()
        pre_caches = [{k: v.clone() for k, v in e.items()} for e in caches]
        tp = pstep.model_axis
        toks, all_logits = [], [logits]
        tok = greedy_token(logits, cfg, tp)
        collectives.reset_counts()
        for i in range(NEW):
            toks.append(tok)
            caches, logits = dstep(params, caches, tok, S_ + i)
            all_logits.append(logits)
            tok = greedy_token(logits, cfg, dstep.model_axis)
        toks.append(tok)
        lay = pstep.layout
        held = [(x.numel(), lay.pieces(k), int(np.prod(lay.shapes[k])))
                for k, x in enumerate(tree_leaves(params))]
        axis = None if tp is None else dict(size=tp.size, rank=tp.rank, heads=tp.heads,
                                            kv=tp.kv, mlp=tp.mlp, vocab=tp.vocab, sp=tp.sp,
                                            expert=tp.expert)
        torch.save({"logits": all_logits, "toks": toks, "pre_caches": pre_caches,
                    "caches": caches, "rows": pstep.rows, "coords": m.coords, "axis": axis,
                    "kv_heads": held_kv_heads(cfg, tp), "held": held,
                    "pre_counts": pre_counts, "dec_counts": collectives.counts(),
                    "flags_groups": pstep.flags.n_dp_shards,
                    "held_caches": specs["held_caches"]},
                   os.path.join(out_dir, f"{c['name']}.{mesh.rank}.pt"))


# ---------------------------------------------------------------------------
# the JAX side (imported in the test process only)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def jax_params(name):
    import jax
    import jax.numpy as jnp

    from repro.configs import base as jbase
    from repro.models import params as jparams

    return jparams.init_params(cfg_of(jbase, name), jax.random.PRNGKey(0), jnp.float32)


def batch_of(name, S_):
    from repro_torch.data.pipeline import make_batch

    b = make_batch(cfg_of(tbase, name), tbase.ShapeConfig("p", S_, B, "prefill"), step=0)
    b.pop("labels")
    return b


@functools.lru_cache(maxsize=None)
def jax_run(name, groups, S_):
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

    jcfg = cfg_of(jbase, name)
    L = S_ + NEW
    flags = jmodel.ExecFlags(remat="none", attn_chunk=S_, n_dp_shards=groups)
    mesh = make_host_mesh()
    par = jbase.ParallelConfig(fsdp=False)
    with mesh:
        pre, *_ = jprefill(jcfg, par, mesh, jbase.ShapeConfig("p", S_, B, "prefill"),
                           flags=flags, max_len=L)
        dec, *_ = jdecode(jcfg, par, mesh, jbase.ShapeConfig("d", L, B, "decode"), flags=flags)
        caches, logits = pre(jax_params(name), jax.tree.map(jnp.asarray, batch_of(name, S_)))
    pre_caches = jax.tree.map(np.asarray, caches)
    out_logits, toks = [np.asarray(logits)], []
    tok = jgreedy(logits, jcfg)
    for i in range(NEW):
        toks.append(np.asarray(tok))
        with mesh:
            caches, logits = dec(jax_params(name), caches, tok, jnp.int32(S_ + i))
        out_logits.append(np.asarray(logits))
        tok = jgreedy(logits, jcfg)
    toks.append(np.asarray(tok))
    return out_logits, toks, pre_caches, jax.tree.map(np.asarray, caches)


def init_file(tmp_path, cases) -> str:
    import jax

    from repro_torch.bridge import params_from_numpy

    path = str(tmp_path / "init.pt")
    out = {}
    for c in cases:
        name = c["cfg"]
        if name not in out:
            out[name] = {"params": params_from_numpy(jax.tree.map(np.asarray, jax_params(name)),
                                                     cfg_of(tbase, name), device="cpu"),
                         "batch": batch_of(name, seq_of(c))}
    torch.save(out, path)
    return path


def close(got, want, what, atol=RTOL):
    """``got`` within rtol 1e-5 of ``want``, with an absolute term of
    ``atol`` of ``want``'s largest magnitude (at least ``atol``; the module
    docstring)."""
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol * scale, err_msg=what)


def kv_index(cfg, axis) -> list:
    """The KV heads a rank's cache holds, by index (``local_kv``'s rule,
    written out again)."""
    KV, H = cfg.n_kv_heads, cfg.n_heads
    if axis is None or not axis["heads"]:
        return list(range(KV))
    M, m = axis["size"], axis["rank"]
    if axis["kv"]:
        return list(range(m * KV // M, (m + 1) * KV // M))
    g, hl = H // KV, H // M
    h0 = m * hl
    if hl % g == 0:
        return list(range(h0 // g, h0 // g + hl // g))
    if g % hl == 0:
        return [h0 // g]
    return [(h0 + i) // g for i in range(hl)]


def check_case(c, D, M, ranks):
    """Ids, logits, caches and held slices of one case (the module
    docstring)."""
    cfg = cfg_of(tbase, c["cfg"])
    name = c["name"]
    S_ = seq_of(c)
    atol = SSM_ATOL if cfg.family == "ssm" else RTOL
    jl, jt, jpre, jend = jax_run(c["cfg"], groups_of(c, D, M), S_)
    for r, x in enumerate(ranks):
        rows = x["rows"]
        for i, (t, j) in enumerate(zip(x["toks"], jt)):
            assert np.array_equal(t.numpy(), j[rows]), (name, r, i, t, j[rows])
        for i, (t, j) in enumerate(zip(x["logits"], jl)):
            j = j[rows]
            if t.shape[-1] != j.shape[-1]:  # this rank's vocabulary columns
                V = t.shape[-1]
                j = j[:, x["axis"]["rank"] * V:(x["axis"]["rank"] + 1) * V]
            close(t, j, f"{name} rank {r} logits {i}", atol)
        heads = kv_index(cfg, x["axis"])
        assert x["kv_heads"] == len(heads), (name, r)
        for what, got, want in (("prefill", x["pre_caches"], jpre), ("end", x["caches"], jend)):
            for p, (te, je) in enumerate(zip(got, want)):
                for k in te:
                    w = je[k][:, rows]
                    if k in ("k", "v"):
                        w = w[:, :, :, heads]
                    assert tuple(te[k].shape) == w.shape, (name, r, what, k)
                    close(te[k], w, f"{name} rank {r} {what} cache {p}.{k}", atol)
        for n, pieces, whole in x["held"]:
            assert n * pieces == whole, name
    assert len({x["flags_groups"] for x in ranks}) == 1


def check_tp_bytes(c, cfg, x):
    """The model axis's all-reduce bytes of the prefill and of the decode
    steps, from the shapes: the embedding's (where the vocabulary is cut;
    a vision prompt's text positions, none for audio frames) and each
    layer's attention and dense FFN outputs, (rows, positions, d) f32."""
    axis = x["axis"]
    if axis is None or axis["sp"] or c["smode"] == "fsdp":
        return
    rows = x["rows"].stop - x["rows"].start
    S_ = seq_of(c)
    text = {"vision": S_ - cfg.n_patches, "audio": 0}.get(cfg.frontend, S_)
    for counts, seq, emb, steps in ((x["pre_counts"], S_, text, 1), (x["dec_counts"], 1, 1, NEW)):
        ar = counts.get("all_reduce", {})
        act = rows * seq * cfg.d_model * 4 * steps
        want = {"tp:attn_out": cfg.n_layers * act if axis["heads"] else 0,
                "tp:ffn_out": cfg.n_layers * act if cfg.moe is None and axis["mlp"] else 0,
                "tp:embed": rows * emb * cfg.d_model * 4 * steps if axis["vocab"] else 0}
        for tag, n in want.items():
            assert ar.get(tag, {"bytes": 0})["bytes"] == n, (c["name"], tag, ar.get(tag), n)


def run_mesh(D, M, tmp_path, cases):
    init_path = init_file(tmp_path, cases)
    spawn(serve_ranks, D * M, cases, init_path, str(tmp_path), model=M, device="cpu",
          timeout=600)
    for c in cases:
        ranks = [torch.load(tmp_path / f"{c['name']}.{r}.pt", weights_only=False)
                 for r in range(D * M)]
        check_case(c, D, M, ranks)
        cfg = cfg_of(tbase, c["cfg"])
        for x in ranks:
            check_tp_bytes(c, cfg, x)
            if cfg.moe is not None:  # the experts' exchange of its mode
                kind = {"gather": "all_gather", "a2a": "all_to_all"}[x["axis"]["expert"]]
                assert f"ep:{x['axis']['expert']}" in x["pre_counts"][kind], c["name"]
                assert f"ep:{x['axis']['expert']}" in x["dec_counts"][kind], c["name"]
    return ranks


@pytest.mark.parametrize("D,M", [(1, 2), (1, 4), (2, 2)])
def test_serve_steps_match_jax_global_batch(D, M, tmp_path):
    run_mesh(D, M, tmp_path, CASES[(D, M)])


# ---------------------------------------------------------------------------
# unit checks without ranks
# ---------------------------------------------------------------------------


def _stand_in(data, model):
    return SimpleNamespace(axis_names=("data", "model"), shape={"data": data, "model": model},
                           sizes=(data, model), devices=np.empty((data, model)))


def _registered():
    from repro.configs import base as jbase

    jbase.get_config("llama-350m")  # fills the registry
    return sorted(jbase._REGISTRY)


def _translate(tree):
    """A JAX tree of ShapeDtypeStructs or PartitionSpecs as plain tuples."""
    import jax

    def one(x):
        if isinstance(x, jax.ShapeDtypeStruct):
            return (tuple(x.shape), str(x.dtype))
        return tuple(x)

    return jax.tree.map(one, tree, is_leaf=lambda x: isinstance(
        x, (jax.ShapeDtypeStruct, jax.sharding.PartitionSpec)))


def _port(tree):
    if isinstance(tree, dict):
        return {k: _port(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and tree and isinstance(tree[0], dict):
        return tuple(_port(v) for v in tree)
    if isinstance(tree, tuple) and len(tree) == 2 and isinstance(tree[1], torch.dtype):
        return (tuple(tree[0]), str(tree[1]).replace("torch.", ""))
    return tuple(tree)


@pytest.mark.parametrize("name", _registered())
def test_serve_input_specs_and_cache_annotations_match_jax(name):
    from repro.configs import base as jbase
    from repro.launch import specs as jspecs
    from repro.launch.steps import build_rules as jrules
    from repro.models.kvcache import cache_annotations as jann

    from repro_torch.launch import specs as tspecs
    from repro_torch.launch.steps import build_rules
    from repro_torch.models.kvcache import cache_annotations

    jcfg, tcfg = jbase.get_config(name), tbase.get_config(name)
    assert cache_annotations(tcfg) == jann(jcfg)
    for D, M in ((16, 16), (2, 2)):
        mesh = _stand_in(D, M)
        msd = {"data": D, "model": M}
        jr, tr = jrules(jcfg, mesh, jbase.ParallelConfig()), build_rules(tcfg, mesh,
                                                                          tbase.ParallelConfig())
        for kind, S_, B_ in (("prefill", 1024, 32), ("decode", 2048, 32), ("decode", 64, 3)):
            js, jp = jspecs.input_specs(jcfg, jbase.ShapeConfig("c", S_, B_, kind), jr, msd)
            ts, tp = tspecs.input_specs(tcfg, tbase.ShapeConfig("c", S_, B_, kind), tr, msd)
            assert _port(ts) == _translate(js), (name, D, M, kind)
            assert _port(tp) == _translate(jp), (name, D, M, kind)


def test_glm4_cache_is_cut_over_head_dim_where_the_port_holds_local_kv():
    """glm4-9b's 2 KV heads at M = 4: the JAX rules cut the cache's head
    dim; a rank of the port holds the one whole KV head its 8 query heads
    share, twice the bytes of a head-dim cut."""
    from repro.configs import base as jbase
    from repro.launch import specs as jspecs
    from repro.launch.steps import build_rules as jrules

    from repro_torch.launch import specs as tspecs
    from repro_torch.launch.steps import build_rules, model_cuts
    from repro_torch.models.kvcache import cache_annotations, held_cache_bytes
    from repro_torch.parallel.sharding import held_cache_spec

    name, D, M = "glm4-9b", 1, 4
    jcfg, tcfg = jbase.get_config(name), tbase.get_config(name)
    mesh, msd = _stand_in(D, M), {"data": D, "model": M}
    shape = ("d", 4096, 8, "decode")
    _, jp = jspecs.input_specs(jcfg, jbase.ShapeConfig(*shape),
                               jrules(jcfg, mesh, jbase.ParallelConfig()), msd)
    tr = build_rules(tcfg, mesh, tbase.ParallelConfig())
    _, tp = tspecs.input_specs(tcfg, tbase.ShapeConfig(*shape), tr, msd)
    want = (None, "data", None, None, "model")  # the cache_hd cut
    assert tuple(jp["caches"][0]["k"]) == want and tuple(tp["caches"][0]["k"]) == want
    cuts = model_cuts(tcfg, mesh, tbase.ParallelConfig())
    assert "heads" in cuts and "kv_heads" not in cuts
    axis = SimpleNamespace(heads=True, kv=False, size=M)
    assert held_kv_heads(tcfg, axis) == 1
    held = held_cache_spec(cache_annotations(tcfg)[0]["k"], ("data",), tr, kv_cut=False)
    assert tuple(held) == (None, "data", None, None, None)
    ours = held_cache_bytes(tcfg, 8, 4096, 1)
    jaxs = held_cache_bytes(tcfg, 8, 4096, tcfg.n_kv_heads, hd_pieces=M)
    assert ours == 2 * jaxs == 2 * 40 * 8 * 4096 * 128 * 2


class _ThreadComm:
    """A model group of ``world`` threads: all-reduce (max) through shared
    slots, for ``greedy_token`` without processes."""

    def __init__(self, slots, barrier, rank, world):
        self.slots, self.barrier, self.rank, self.world = slots, barrier, rank, world

    def all_reduce(self, t, op="sum", tag=""):
        self.slots[self.rank] = t.clone()
        self.barrier.wait()
        red = torch.stack(self.slots).amax(0) if op == "max" else torch.stack(self.slots).sum(0)
        self.barrier.wait()
        t.copy_(red)
        return t


@pytest.mark.parametrize("M", [2, 4])
def test_vocab_cut_greedy_takes_jnp_argmax_id_on_ties(M):
    import jax.numpy as jnp

    cfg = tbase.ModelConfig(vocab_size=250)  # padded to 256
    V = cfg.padded_vocab
    rng = np.random.default_rng(M)
    logits = rng.integers(0, 4, size=(6, V)).astype(np.float32)  # ties everywhere
    logits[0] = 0.0  # one tie across every rank
    logits[1, 3], logits[1, V // M + 3] = 9.0, 9.0  # ranks 0 and 1 tie
    logits[2, :] = -5.0
    logits[:, cfg.vocab_size:] = 1e30  # pad columns: never an id
    want = np.asarray(jnp.argmax(jnp.asarray(logits[:, :cfg.vocab_size]), axis=-1))
    slots, barrier, got = [None] * M, threading.Barrier(M), [None] * M

    def rank(m):
        comm = _ThreadComm(slots, barrier, m, M)
        tp = SimpleNamespace(vocab=True, rank=m, size=M, comm=comm)
        piece = torch.from_numpy(logits[:, m * V // M:(m + 1) * V // M].copy())
        got[m] = greedy_token(piece, cfg, tp)

    threads = [threading.Thread(target=rank, args=(m,)) for m in range(M)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for m in range(M):
        assert np.array_equal(got[m].numpy(), want), (m, got[m], want)


def test_ssm_serve_steps_refuse_a_model_axis():
    """The SSM serve steps take a model axis (the mixer cut by its heads,
    ``tests/test_torch_serve_mesh_ssm.py``); a data axis other than
    ``data`` is still refused."""
    mesh = _stand_in(1, 2)
    cfg = tbase.reduced(tbase.get_config("mamba2-2.7b"), dtype="float32")
    from repro_torch.launch.steps import model_cuts

    assert "ssm_inner" in model_cuts(cfg, mesh, tbase.ParallelConfig())
    for make, kind in ((make_prefill_step, "prefill"), (make_decode_step, "decode")):
        with pytest.raises(NotImplementedError, match="the port runs"):
            make(cfg, tbase.ParallelConfig(dp_axes=("replica",)), mesh,
                 tbase.ShapeConfig("s", 32, 4, kind))
