"""The V1 hazard at a small size, and why the benchmark's weights carry a
planted spectrum (``bench/weights.py``).

MeCeFO's V1 is the top-64 left singular subspace of each FFN matrix.  The
program refreshes it from the bf16 weights (``refresh_projections``, an
f32 SVD whose vectors it rounds to bf16); the reference works it out from
the weights as they were meant.  Measured as the sine of the largest
principal angle between the two subspaces, at glm4-9b's aspect ratio
(w_up 4096 x 13696 and w_down, cut to 512 x 1712 and 1712 x 512), over
seeds 1-3 (CPU):

- planted weights: 0.00213-0.00219, the rounding of V1 itself to bf16
  (~2^-9): the subspace does not move with the weights' last bits;
- plain Gaussian weights of the same shapes: 0.0115-0.0289: singular
  values near the 64th lie ~1e-3 of their size apart, so rounding the
  weights to bf16 tilts the subspace 5-13 times as far.

``TOL`` = 0.005, the geometric middle of the two sides' nearest readings
(0.00219 and 0.0115): 2.3 times above the one and below the other.  The
reference's subspace iteration reads 1.1e-6-1.3e-6 against the exact SVD
on the planted weights."""
import pytest
import torch

from weights import make_leaf

TOL = 0.005


def _largest_angle(a, b):
    """The sine of the largest principal angle between the spans: the
    largest singular value of a's basis less its projection on b's."""
    qa, qb = torch.linalg.qr(a.double()).Q, torch.linalg.qr(b.double()).Q
    return float(torch.linalg.svdvals(qa - qb @ (qb.T @ qa)).max())


def _program_v1(w_bf16):
    from repro_torch.configs.base import get_config
    from repro_torch.core.lowrank import refresh_projections

    tree = {"layers": ({"mixer": {}, "ffn": {"w_up": w_bf16[None]}},)}
    return refresh_projections(tree, get_config("glm4-9b"), 64)["layers"][0]["ffn"]["w_up"][0]


@pytest.mark.parametrize("shape", [(512, 1712), (1712, 512)])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_planted_weights_pin_v1_and_gaussian_ones_do_not(shape, seed):
    torch.set_num_threads(2)
    cpu = torch.device("cpu")
    meant = make_leaf("layers.0.ffn.w_up", (1,) + shape, seed, cpu, torch.bfloat16, 64, f32=True)[0]
    held = make_leaf("layers.0.ffn.w_up", (1,) + shape, seed, cpu, torch.bfloat16, 64)[0]
    assert torch.equal(held, meant.to(torch.bfloat16))
    ref = torch.linalg.svd(meant, full_matrices=False)[0][:, :64]
    assert _largest_angle(_program_v1(held).float(), ref) < TOL
    g = torch.randn(shape, generator=torch.Generator().manual_seed(seed)) / shape[0] ** 0.5
    gref = torch.linalg.svd(g, full_matrices=False)[0][:, :64]
    assert _largest_angle(_program_v1(g.to(torch.bfloat16)).float(), gref) > TOL


def test_the_reference_subspace_iteration_finds_the_planted_subspace():
    from reference.model import top_subspace

    w = make_leaf("layers.0.ffn.w_up", (1, 512, 1712), 5, torch.device("cpu"), torch.float32, 64)[0]
    exact = torch.linalg.svd(w, full_matrices=False)[0][:, :64]
    assert _largest_angle(top_subspace(w, 64), exact) < 1e-5
