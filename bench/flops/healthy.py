"""The healthy program (``ndb_mode="off"``): every product's forward, and
its backward at twice the forward (the input and the weight gradients),
attention's core included: 6 N D plus causal attention."""
from __future__ import annotations

from flops import forward_parts


def step_flops(m: dict, B: int, S: int) -> float:
    return 3.0 * sum(forward_parts(m, B, S).values())
