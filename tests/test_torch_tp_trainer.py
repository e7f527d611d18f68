"""The port's Trainer on a ``model`` mesh axis against the live JAX
Trainer, on the CPU: mesh (1, 2) of gloo ranks, tensor parallelism over
the reduced llama-350m's heads, FFN and vocabulary, replaying
``golden_trace_elastic.jsonl`` (the checks of
``tests/test_torch_trainer.py`` at W = 2)."""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.launch.dist import spawn  # noqa: E402

DATA = pathlib.Path(__file__).parent / "data"


def test_trainer_on_a_model_axis_matches_jax_on_the_elastic_golden_trace(tmp_path):
    """The port's Trainer on mesh (1, 2), TP over the reduced config's heads,
    FFN and vocab, against the live JAX Trainer over
    ``golden_trace_elastic.jsonl``: per-step loss and grad norm at 1e-5, the
    step fields, accounting and incidents equal on both ranks, the replay
    verdict agreed (``tests/test_torch_trainer.py``'s checks at W = 2; the
    incidents other than the wall-clock step-time spikes)."""
    import jax

    from repro.configs import base as jbase
    from repro.launch import train as jtrain
    from repro_torch.bridge import state_from_numpy
    from tests.test_torch_dist import trainer_rank
    from tests.test_torch_trainer import EXACT, LOSS_RTOL, _incidents

    name = "golden_trace_elastic.jsonl"
    steps = json.loads((DATA / name).read_text().splitlines()[-1])["total_steps"]
    jcfg = jbase.reduced(jbase.get_config("llama-350m"), dtype="float32")
    tcfg = tbase.reduced(tbase.get_config("llama-350m"), dtype="float32")
    mecefo = dict(mode="dynamic", rank=16, svd_period=20)
    jtr = jtrain.Trainer(jcfg, jbase.ShapeConfig("cli", 128, 8, "train"),
                         jbase.TrainConfig(steps=steps), mecefo=jbase.MeCeFOConfig(**mecefo),
                         trace_replay=str(DATA / name))
    init = tmp_path / "init.pt"
    torch.save(state_from_numpy(jax.tree.map(np.asarray, jtr.state), tcfg, device="cpu"), init)
    jh = jtr.run(log_every=0)
    args = (tcfg, tbase.ShapeConfig("cli", 128, 8, "train"), tbase.TrainConfig(steps=steps))
    kwargs = dict(mecefo=tbase.MeCeFOConfig(**mecefo), trace_replay=str(DATA / name))
    spawn(trainer_rank, 2, args, kwargs, str(init), str(tmp_path / "rank"), model=2,
          device="cpu", timeout=600)
    ranks = [torch.load(tmp_path / f"rank.{r}.pt", weights_only=False) for r in range(2)]
    assert all(r["ok"] for r in ranks)
    for r in ranks:
        assert len(r["hist"]) == len(jh) == steps
        for j, t in zip(jh, r["hist"]):
            assert {k: t[k] for k in EXACT} == {k: j[k] for k in EXACT}
            np.testing.assert_allclose(t["loss"], j["loss"], rtol=LOSS_RTOL, err_msg=f"{t['step']}")
            np.testing.assert_allclose(t["grad_norm"], j["grad_norm"], rtol=LOSS_RTOL,
                                       err_msg=f"{t['step']}")
        assert r["acc"] == jtr.controller.accounting.as_dict()
        # the step-time spike detector reads wall clocks (its incidents are
        # synthetic, never verified bit-exactly): the others must agree
        assert _timeless(r["incidents"]) == _timeless(_incidents(jtr))
    assert [t["loss"] for t in ranks[1]["hist"]] == [t["loss"] for t in ranks[0]["hist"]]


def _timeless(incidents):
    return [i for i in incidents if i[0] != "step_time_spike"]
