"""``bench/flops/`` against the port's own counter (``launch/cost.py``'s
``CostMode`` over a dry step on the meta device, whose kernels book their
work as on the card) at a tiny size, for both programs, dense and MoE.

The counter counts every product that runs; the yardstick counts what the
program needs.  What lies between them is written out here, exactly:

- the elementwise kernels' bookings (#3 RMSNorm, #4 SwiGLU and its
  backward), which the yardstick does not count;
- the chunked cross-entropy's recompute: the head's forward once more;
- healthy: the attention backward recomputes the plain attention over all
  S^2 (query, key) pairs (two forward and four backward products) where the
  yardstick counts twice the causal forward;
- neighbour: the FFN's recompute (technique II): its forward products once
  more, except an MoE layer's combine, which PyTorch's checkpoint leaves
  out when it stops its recompute early.

MoE cells run at capacity factor 1, where the experts' buffers hold exactly
the top-k slots the yardstick counts."""
import copy

import pytest
from conftest import TINY_DENSE, TINY_MOE, read_json

import flops
from flops import degraded, healthy
from program import program_config
from spec import Cell
from conftest import BENCH


def _cell(conf, mode):
    conf = copy.deepcopy(conf)
    if "num_experts" in conf:
        conf["port"]["capacity_factor"] = 1.0
        conf["program_config"] = "bench-tiny-qwen3-moe-cf1"
    t = read_json(f"{BENCH}/traffic/{'neighbor' if mode == 'degraded' else 'healthy'}.json")
    t["seq_len"], t["mecefo"]["rank"] = 32, 8
    return Cell("tiny", "tiny", mode, conf, t, {}, 1)


@pytest.mark.parametrize("conf", [TINY_DENSE, TINY_MOE], ids=["dense", "moe"])
@pytest.mark.parametrize("mode", ["off", "degraded"])
def test_flops_agree_with_the_cost_counter(conf, mode):
    from repro_torch.configs.base import MeCeFOConfig, ShapeConfig
    from repro_torch.launch.dryrun import dry_step
    from repro_torch.models.model import ExecFlags

    cell = _cell(conf, mode)
    m, B, S = cell.sizes, cell.batch, cell.seq_len
    step = dry_step(program_config(cell), ShapeConfig("tiny", S, B, "train"), ndb=mode,
                    mecefo=MeCeFOConfig(mode="dynamic", rank=m["rank"]),
                    flags=ExecFlags(remat="none"))
    f = flops.forward_parts(m, B, S)
    kw = step.cost.kernel_work
    extra = sum(kw.get(k, {}).get("flops", 0.0) for k in ("rmsnorm", "swiglu", "swiglu_bwd"))
    extra += f["head"]
    if mode == "off":
        full = 2.0 * B * m["heads"] * S * S * m["head_dim"] * m["layers"]
        extra += 6 * full - 2 * f["attn_core"]
        mine = healthy.step_flops(m, B, S)
    else:
        extra += f["ffn"] + f.get("router", 0.0)
        mine = degraded.step_flops(m, B, S)
    assert step.cost.flops == pytest.approx(mine + extra, rel=1e-12)
