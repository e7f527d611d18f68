"""Roofline terms of a dry run (the counterpart of ``repro.launch.roofline``).

Three terms per (arch × shape × mesh), all **seconds per step, per rank**,
from one rank's counts (``launch/cost.py``):

  compute    = FLOPs / PEAK_FLOPS
  memory     = HBM bytes / HBM_BW
  collective = collective bytes / NET_BW

None of the constants is measured here: one card cannot time a
collective.  The collective bytes are kept by group
(``collectives_by_group``) so that a later model can give the groups
inside a node NVLink's rate instead.

MODEL_FLOPS is the analytic useful-work estimate (6·N·D style, MoE counts
active params only, plus explicit attention/SSD terms): a count of a
step's work that does not depend on which implementation ran, the
yardstick of a share of the roofline and of an MFU.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

from repro_torch.configs.base import ModelConfig, ShapeConfig

# H100 SXM, NVIDIA data sheet: dense bf16 tensor-core peak
PEAK_FLOPS = 989e12
# H100 SXM, NVIDIA data sheet: HBM3 bandwidth
HBM_BW = 3.35e12
# one 400 Gb/s NIC a GPU (50e9 B/s), as the reference budgets one ICI link
NET_BW = 50e9


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops_per_dev: float
    bytes_per_dev: float
    collective_bytes_per_dev: float
    collectives: Dict[str, int]  # bytes by kind
    model_flops_global: float
    bytes_per_dev_peak: float  # the dry run's peak live bytes
    seconds: float = 0.0
    collectives_by_group: Dict[str, int] = field(default_factory=dict)  # bytes by group
    extras: Dict = field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        return self.flops_per_dev / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_dev / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_dev / NET_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        tot = self.flops_per_dev * self.n_devices
        return self.model_flops_global / tot if tot else 0.0

    @property
    def roofline_fraction(self) -> float:
        """MODEL_FLOPS-based MFU bound implied by the dominant term."""
        t = max(self.t_compute, self.t_memory, self.t_collective)
        if t <= 0:
            return 0.0
        return self.model_flops_global / (t * self.n_devices * PEAK_FLOPS)

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "n_devices": self.n_devices,
            "flops_per_dev": self.flops_per_dev,
            "bytes_per_dev": self.bytes_per_dev,
            "collective_bytes_per_dev": self.collective_bytes_per_dev,
            "collectives": self.collectives,
            "collectives_by_group": self.collectives_by_group,
            "model_flops_global": self.model_flops_global,
            "bytes_per_dev_peak": self.bytes_per_dev_peak,
            "t_compute": self.t_compute,
            "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "seconds": self.seconds,
            **self.extras,
        }


# ---------------------------------------------------------------------------
# Analytic MODEL_FLOPS
# ---------------------------------------------------------------------------


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Useful FLOPs per step (global), 6·N·D convention + mixer terms."""
    from repro_torch.models.params import count_params

    n_active = count_params(cfg, active_only=True)
    embed = cfg.padded_vocab * cfg.d_model
    n_matmul = n_active - embed  # embed lookup is a gather, not a matmul
    if cfg.tie_embeddings:
        n_matmul += embed  # the tied unembed matmul is real compute

    B, S = shape.global_batch, shape.seq_len
    hd = cfg.resolved_head_dim

    def attn_fwd_tokens(tokens_q, kv_len):
        # 2 matmuls (qk, pv): 4 * heads * hd * kv_len per q token; causal ~ /2
        n_attn_layers = sum(
            1 for l in range(cfg.n_layers) if cfg.layer_kind(l) == "attn"
        )
        causal = 0.5 if shape.kind != "decode" else 1.0
        return 4.0 * n_attn_layers * cfg.n_heads * hd * kv_len * tokens_q * causal

    def ssd_fwd_tokens(tokens):
        if cfg.ssm is None:
            return 0.0
        n_ssm = sum(1 for l in range(cfg.n_layers) if cfg.layer_kind(l) == "ssm")
        d_inner = cfg.ssm.expand * cfg.d_model
        nh = d_inner // cfg.ssm.head_dim
        Q = cfg.ssm.chunk
        N = cfg.ssm.d_state
        # intra-chunk (cb + y_intra, causal ~/2) + chunk states + inter
        per_tok = (2 * Q * N + 2 * Q * nh * cfg.ssm.head_dim) * 0.5
        per_tok += 4 * N * d_inner  # state outer products + readout
        return n_ssm * per_tok * tokens

    if shape.kind == "train":
        D = B * S
        return 6.0 * n_matmul * D + 3.0 * (attn_fwd_tokens(D, S) / 1.0) + 3.0 * ssd_fwd_tokens(D)
    if shape.kind == "prefill":
        D = B * S
        return 2.0 * n_matmul * D + attn_fwd_tokens(D, S) + ssd_fwd_tokens(D)
    # decode: one token per sequence against a seq_len cache
    D = B
    return 2.0 * n_matmul * D + attn_fwd_tokens(D, S) + ssd_fwd_tokens(D)


def summarize(report: RooflineReport) -> str:
    r = report
    return (
        f"{r.arch:22s} {r.shape:12s} {r.mesh:6s} "
        f"compute={r.t_compute*1e3:9.3f}ms memory={r.t_memory*1e3:9.3f}ms "
        f"coll={r.t_collective*1e3:9.3f}ms -> {r.bottleneck:10s} "
        f"useful={r.useful_flops_ratio:6.1%} roofline={r.roofline_fraction:6.1%}"
    )


__all__ = ["HBM_BW", "NET_BW", "PEAK_FLOPS", "RooflineReport", "model_flops", "summarize"]
