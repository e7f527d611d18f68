"""The neighbour program (``ndb_mode="degraded"``): the forward; the
head's input and weight gradients; the FFN's (or the router's, experts'
and combine's) input gradients; the router's exact weight gradient; each
FFN or expert matrix W (n, m) its low-rank weight gradient over its t
tokens, 2 t r (n + m) for (x V1)^T dy and 2 r n m for V1 A; no attention
backward at all (its branch passes no gradient, its weights get none)."""
from __future__ import annotations

from flops import forward_parts


def step_flops(m: dict, B: int, S: int) -> float:
    f = forward_parts(m, B, S)
    T, L, d, r = B * S, m["layers"], m["d"], m["rank"]
    total = sum(f.values()) + 2 * f["head"] + f["ffn"]
    if m.get("moe"):
        E, k, fe = m["moe"]["experts"], m["moe"]["top_k"], m["moe"]["d_ff"]
        total += 2 * f["router"] + 2 * f["combine"]
        total += 3 * L * (2.0 * T * k * r * (d + fe) + E * 2.0 * r * d * fe)
    else:
        fd = m["d_ff"]
        total += 3 * L * (2.0 * T * r * (d + fd) + 2.0 * r * d * fd)
    return total
