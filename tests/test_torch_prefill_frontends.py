"""The port's prefill through the modality frontends against the live JAX
functions, on the CPU.

``forward_prefill`` and ``forward_prefill_chunk`` embed their batch
through ``frontends.embed_inputs``, as the JAX package's do: the vision
stub's patch embeddings go before the embedded tokens, and the audio
stub's frame embeddings take the tokens' place.  The configs are
``reduced(phi-3-vision-4.2b)`` (8 patches) and ``reduced(musicgen-medium)``
in f32 with the JAX weights carried across the bridge; the batches are the
data pipeline's, made from a seed.  Caches and logits are held at rtol
1e-5 and an atol of 1e-6 of the tensor's largest magnitude (at least 1e-6:
``tests/test_torch_dist.py``'s tolerances on tensors of order 1), both at
the default last position and at per-row positions, and the vision
config's chunk prefill (two chunks, the second attending to the first's
cache rows) at the same tolerance.  The atol scales because f32 products
summed in torch's and XLA's orders differ by ~10 ulps of the largest
terms: layer 0's K rows alone differ by 2.6e-6 where they reach 3.6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.data.pipeline import make_batch as jax_make_batch  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import params as jparams  # noqa: E402
from repro.models.kvcache import cache_structs as jax_cache_structs  # noqa: E402
from repro.models.kvcache import init_cache as jax_init_cache  # noqa: E402

from repro_torch.bridge import params_from_numpy, tensor_from_numpy  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.models.kvcache import cache_structs  # noqa: E402
from repro_torch.models.model import forward_prefill, forward_prefill_chunk  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
B, S, MAX_LEN = 2, 16, 40
FLAGS = jmodel.ExecFlags(remat="none", attn_chunk=S)


def _setup(name):
    jcfg = jbase.reduced(jbase.get_config(name), dtype="float32")
    tcfg = tbase.reduced(tbase.get_config(name), dtype="float32")
    jp = jparams.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def _batch(jcfg, step):
    b = jax_make_batch(jcfg, jbase.ShapeConfig("p", S, B, "prefill"), step=step)
    b.pop("labels", None)
    return b


def _t(batch):
    return {k: tensor_from_numpy(np.asarray(v), "cpu") for k, v in batch.items()}


def close(got, want, what):
    """``got`` (a tensor) within rtol 1e-5 and 1e-6 of ``want``'s largest
    magnitude (at least 1e-6) of ``want`` (the module docstring)."""
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL * max(1.0, float(np.abs(want).max(initial=0.0))),
                               err_msg=what)


@pytest.mark.parametrize("name", ["phi-3-vision-4.2b", "musicgen-medium"])
def test_prefill_through_the_frontends_matches_jax(name, local_rules):
    jcfg, tcfg, jp, tp = _setup(name)
    batch = _batch(jcfg, 0)
    assert ("patch_embeds" in batch) == (name.startswith("phi")), sorted(batch)
    for logit_pos in (None, np.array([S - 1, S // 2 + 1])):
        jc, jl = jmodel.forward_prefill(
            jp, jax.tree.map(jnp.asarray, batch), jcfg, local_rules, FLAGS,
            jax_cache_structs(jcfg, B, S),
            logit_pos=None if logit_pos is None else jnp.asarray(logit_pos))
        tc, tl = forward_prefill(
            tp, _t(batch), tcfg, cache_structs(tcfg, B, S),
            logit_pos=None if logit_pos is None else torch.from_numpy(logit_pos))
        close(tl, jl, f"{name} logits at {logit_pos}")
        for i, (je, te) in enumerate(zip(jc, tc)):
            for k in te:
                close(te[k], je[k], f"{name} cache {i}.{k}")


def test_vision_chunk_prefill_matches_jax(local_rules):
    jcfg, tcfg, jp, tp = _setup("phi-3-vision-4.2b")
    jc = jax_init_cache(jcfg, B, MAX_LEN)
    tc = tuple({k: torch.zeros(s.shape, dtype=s.dtype) for k, s in e.items()}
               for e in cache_structs(tcfg, B, MAX_LEN))
    off = 0
    for step, idx in ((0, S - 1), (1, 3)):
        batch = _batch(jcfg, step)
        jc, jl = jmodel.forward_prefill_chunk(jp, jc, jax.tree.map(jnp.asarray, batch), off,
                                              jcfg, local_rules, FLAGS, idx)
        tc, tl = forward_prefill_chunk(tp, tc, _t(batch), off, tcfg, idx)
        close(tl, jl, f"chunk at {off} logits")
        for i, (je, te) in enumerate(zip(jc, tc)):
            for k in te:
                close(te[k], je[k], f"chunk at {off} cache {i}.{k}")
        off += S
