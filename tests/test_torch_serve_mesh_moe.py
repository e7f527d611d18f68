"""The port's MoE prefill and decode steps over a (1, 2) mesh against the
live JAX steps on the global batch, on the CPU (the rules, tolerances and
checks of ``tests/test_torch_serve_mesh.py``, in a file of its own so its
spawn runs on another test worker).

Reduced qwen3-moe-30b-a3b in f32 (8 experts, top 2, capacity factor 1,
so slots drop) in one spawn of two gloo ranks: expert parallelism under
``sharding_mode="tp_fsdp"`` (``"gather"``: both model ranks route the same
rows and each runs its 4 experts), and under the 2-D ``"fsdp"`` mode
(``"a2a"``: each rank routes its own rows, as group m of the JAX step's
``n_dp_shards = 2``, and the experts' places cross all-to-all), each in
the prefill and in 8 greedy decode steps.
"""
import pytest

torch = pytest.importorskip("torch")

from tests.test_torch_serve_mesh import case, run_mesh  # noqa: E402

CASES = [case("ep-gather", "moe"), case("ep-a2a", "moe", smode="fsdp")]


def test_moe_serve_steps_match_jax_global_batch(tmp_path):
    ranks = run_mesh(1, 2, tmp_path, CASES)
    assert ranks[0]["axis"]["expert"] == "a2a"  # the last case's
