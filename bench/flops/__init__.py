"""The frozen count of the FLOPs a step's program needs, one file a program
(``healthy.py``, ``degraded.py``), from the stage's sizes
(``spec.Cell.sizes``) and the step's batch.  Products and attention only,
as model FLOP utilisation counts them; recomputation is not counted, and
an MoE layer counts the top-k slots of every token (not the capacity
buffer's empty places)."""
from __future__ import annotations


def forward_parts(m: dict, B: int, S: int) -> dict:
    """The forward's FLOPs by part, summed over the stage's layers."""
    T, L, d = B * S, m["layers"], m["d"]
    H, KV, hd = m["heads"], m["kv_heads"], m["head_dim"]
    pairs = B * H * S * (S + 1) // 2
    out = {"attn_proj": 2.0 * T * L * (2 * d * H * hd + 2 * d * KV * hd),
           "attn_core": 4.0 * hd * pairs * L,
           "head": 2.0 * T * d * m["vocab"]}
    if m.get("moe"):
        E, k, f = m["moe"]["experts"], m["moe"]["top_k"], m["moe"]["d_ff"]
        out["router"] = 2.0 * T * d * E * L
        out["ffn"] = 2.0 * T * k * 3 * d * f * L
        out["combine"] = 2.0 * T * k * d * L
    else:
        out["ffn"] = 2.0 * T * 3 * d * m["d_ff"] * L
    return out
