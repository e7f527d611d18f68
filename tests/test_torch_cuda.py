"""The CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and ``nvcc`` (the kernels are built from
``src/repro_torch/csrc`` at first use); elsewhere they skip.  On a machine
with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 1e-5 (the kernels and the plain versions sum in other
orders), bf16 one bf16 ulp relative (2^-7) plus 1e-2 absolute for values
rounded on either side of a bf16 boundary.  Gradients through a kernel's
autograd Function are the plain version's exactly (its backward recomputes
the plain version).  Kernel #6 is held at 1e-4 relative to max |ref| in
both dtypes: both sides multiply the same operands with f32 products and
sums, and differ only in summation order (bf16: P split into two bf16
terms, ~2^-17 relative).  The bf16 flash attention is also held within
half a bf16 ulp of the f32 function plus ``ROUND_SLACK`` of the magnitude
of its terms (``kernels/flash_attention.py:rounding_ratio``).
"""
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from repro_torch.kernels import _build

    try:
        _build.nvcc_path()
    except RuntimeError:
        pytest.skip("needs nvcc to build the kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(a, b, dtype):
    atol, rtol = (1e-5, 1e-5) if dtype == torch.float32 else (1e-2, 2 ** -7)
    torch.testing.assert_close(a.float(), b.float(), atol=atol, rtol=rtol)


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(37, 96), (64, 1024), (33, 128), (5, 100)])
def test_rmsnorm_kernel(cuda, dtype, shape):
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain

    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    s = torch.randn(shape[-1], generator=g, device=cuda).to(dtype)
    n = rmsnorm.launches
    _close(rmsnorm(x, s), rmsnorm_plain(x, s), dtype)
    assert rmsnorm.launches == n + 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(37, 100), (8, 3072), (3, 7)])
def test_swiglu_kernel(cuda, dtype, shape):
    from repro_torch.kernels.swiglu import swiglu, swiglu_plain

    gen = torch.Generator(device=cuda).manual_seed(1)
    a = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    b = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    _close(swiglu(a, b), swiglu_plain(a, b), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", [(2, 48, 4, 2, 32), (1, 100, 16, 8, 128), (3, 17, 4, 4, 64),
                                  (2, 256, 16, 16, 64)])
def test_flash_attention_kernel(cuda, dtype, case):
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    B, S, H, KV, hd = case
    gen = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn(B, S, H, hd, generator=gen, device=cuda).to(dtype)
    k = torch.randn(B, S, KV, hd, generator=gen, device=cuda).to(dtype)
    v = torch.randn(B, S, KV, hd, generator=gen, device=cuda).to(dtype)
    _close(flash_attention(q, k, v), flash_attention_plain(q, k, v), dtype)


# the bf16 kernel's tile edges: 64-row q tiles and 64-key K/V tiles
FLASH_EDGE_SEQS = [1, 63, 65, 200, 1000]
FLASH_EDGE_HEADS = [(hd, g) for hd in (32, 64, 128) for g in (1, 2, 4)]


@pytest.mark.parametrize("heads", FLASH_EDGE_HEADS)
@pytest.mark.parametrize("seqs", [(s, s) for s in FLASH_EDGE_SEQS] + [(65, 200), (200, 63)])
def test_flash_attention_bf16_tile_edges_within_rounding_limit(cuda, seqs, heads):
    """bf16 at sequence lengths around the kernel's tiles: within half a
    bf16 ulp (plus the stated slack) of the f32 function, and at the
    kernel-vs-plain tolerance."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain, rounding_ratio,
    )

    (Sq, Sk), (hd, G) = seqs, heads
    B, KV = 2, 2
    gen = torch.Generator(device=cuda).manual_seed(Sq + Sk + hd + G)
    q = torch.randn(B, Sq, KV * G, hd, generator=gen, device=cuda).to(torch.bfloat16)
    k = torch.randn(B, Sk, KV, hd, generator=gen, device=cuda).to(torch.bfloat16)
    v = torch.randn(B, Sk, KV, hd, generator=gen, device=cuda).to(torch.bfloat16)
    out = flash_attention(q, k, v)
    _close(out, flash_attention_plain(q, k, v), torch.bfloat16)
    y = flash_attention_plain(q.float(), k.float(), v.float())
    mag = flash_attention_plain(q.float(), k.float(), v.float().abs())
    assert float(rounding_ratio(out, y, mag).max()) <= 1.0


@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_decode_kernel(cuda, dtype):
    from repro_torch.kernels.paged_decode import paged_decode, paged_decode_plain

    gen = torch.Generator(device=cuda).manual_seed(3)
    B, H, KV, hd, ps, P, n_pages = 5, 16, 8, 128, 16, 6, 40
    q = torch.randn(B, 1, H, hd, generator=gen, device=cuda).to(dtype)
    kp = torch.randn(n_pages, ps, KV, hd, generator=gen, device=cuda).to(dtype)
    vp = torch.randn(n_pages, ps, KV, hd, generator=gen, device=cuda).to(dtype)
    lens = torch.tensor([0, 1, 17, 96, 50], dtype=torch.int32, device=cuda)
    tables = (torch.randperm(n_pages - 1, generator=gen, device=cuda)[: B * P] + 1)
    tables = tables.reshape(B, P).to(torch.int32)
    out = paged_decode(q, kp, vp, tables, lens)
    _close(out, paged_decode_plain(q, kp, vp, tables, lens), dtype)
    assert torch.equal(out[0], torch.zeros_like(out[0]))


FLASH_DECODE_CASES = [
    # (B, Smax, H, KV, hd, lens, block_k)
    (5, 96, 16, 8, 128, [0, 1, 17, 96, 50], 16),
    (3, 100, 8, 2, 64, [100, 33, 64], 64),     # ragged last block
    (2, 40, 4, 1, 32, [7, 40], 128),           # block_k > Smax
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", FLASH_DECODE_CASES)
def test_flash_decode_kernel(cuda, dtype, case):
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain

    B, Smax, H, KV, hd, lens, bk = case
    gen = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn(B, 1, H, hd, generator=gen, device=cuda).to(dtype)
    k = torch.randn(B, Smax, KV, hd, generator=gen, device=cuda).to(dtype)
    v = torch.randn(B, Smax, KV, hd, generator=gen, device=cuda).to(dtype)
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = flash_decode.launches
    out = flash_decode(q, k, v, lens, block_k=bk)
    assert flash_decode.launches == before + 1
    _close(out, flash_decode_plain(q, k, v, lens), dtype)
    zero = lens == 0
    assert torch.equal(out[zero], torch.zeros_like(out[zero]))
    _close(flash_decode(q, k, v, int(lens[-1]), block_k=bk),
           flash_decode_plain(q, k, v, int(lens[-1])), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_decode_bitwise_equals_paged_over_gathered_view(cuda, dtype):
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.paged_decode import paged_decode

    gen = torch.Generator(device=cuda).manual_seed(8)
    B, H, KV, hd, ps, P = 4, 16, 8, 128, 16, 6
    n_pages = 1 + B * P
    q = torch.randn(B, 1, H, hd, generator=gen, device=cuda).to(dtype)
    kp = torch.randn(n_pages, ps, KV, hd, generator=gen, device=cuda).to(dtype)
    vp = torch.randn(n_pages, ps, KV, hd, generator=gen, device=cuda).to(dtype)
    tables = (torch.randperm(n_pages - 1, generator=gen, device=cuda) + 1).reshape(B, P)
    tables = tables.to(torch.int32)
    lens = torch.tensor([0, 5, 48, 96], dtype=torch.int32, device=cuda)
    kd = kp[tables.long()].reshape(B, P * ps, KV, hd)
    vd = vp[tables.long()].reshape(B, P * ps, KV, hd)
    assert torch.equal(flash_decode(q, kd, vd, lens, block_k=ps),
                       paged_decode(q, kp, vp, tables, lens))


def test_flash_decode_refuses_autograd(cuda):
    from repro_torch.kernels.flash_decode import flash_decode

    q = torch.randn(1, 1, 4, 32, device=cuda, requires_grad=True)
    k = torch.randn(1, 16, 2, 32, device=cuda)
    with pytest.raises(RuntimeError, match="autograd"):
        flash_decode(q, k, k, 3)
    with torch.no_grad():
        assert flash_decode(q, k, k, 3).grad_fn is None


@pytest.mark.parametrize("decode", ["paged", "dense"])
def test_engine_goes_through_every_kernel(cuda, decode):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.paged_decode import paged_decode
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.swiglu import swiglu
    from repro_torch.serve import run

    used, unused = (paged_decode, flash_decode) if decode == "paged" else (flash_decode,
                                                                           paged_decode)
    wrappers = (rmsnorm, swiglu, flash_attention, used)
    before = [w.launches for w in wrappers]
    idle = unused.launches
    out = run.main(["--reduced", "--n-requests", "4", "--prompt-len", "4", "40",
                    "--new-tokens", "2", "9", "--max-slots", "2", "--pages-per-slot", "4"]
                   + (["--paged-kernel"] if decode == "paged" else []))
    assert out["n_completed"] == 4
    assert all(w.launches > n for w, n in zip(wrappers, before))
    assert unused.launches == idle


# ---------------------------------------------------------------------------
# the training slice: gradients through the kernels, and kernel #6
# ---------------------------------------------------------------------------


def _grad_cases(dev, dtype):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import swiglu as sg

    g = torch.Generator(device=dev).manual_seed(4)

    def r(*s):
        return torch.randn(*s, generator=g, device=dev).to(dtype)

    return {
        "rmsnorm": (rn.rmsnorm, rn.rmsnorm_plain, rn.rmsnorm_launch, (r(37, 96), r(96))),
        "swiglu": (sg.swiglu, sg.swiglu_plain, sg.swiglu_launch, (r(37, 100), r(37, 100))),
        "flash_attention": (fa.flash_attention, fa.flash_attention_plain, fa.flash_attention_launch,
                            (r(2, 48, 4, 32), r(2, 48, 2, 32), r(2, 48, 2, 32))),
    }


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["rmsnorm", "swiglu", "flash_attention"])
def test_kernel_gradients_match_plain_autograd(cuda, dtype, name):
    wrapper, plain, _launch, inputs = _grad_cases(cuda, dtype)[name]
    a = [t.clone().requires_grad_() for t in inputs]
    b = [t.clone().requires_grad_() for t in inputs]
    launches = wrapper.launches
    ya, yb = wrapper(*a), plain(*b)
    assert wrapper.launches == launches + 1 and ya.grad_fn is not None
    _close(ya, yb, dtype)
    go = torch.randn(ya.shape, generator=torch.Generator(device=cuda).manual_seed(5),
                     device=cuda).to(dtype)
    for ga, gb in zip(torch.autograd.grad(ya, a, go), torch.autograd.grad(yb, b, go)):
        torch.testing.assert_close(ga, gb, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["rmsnorm", "swiglu", "flash_attention"])
def test_bare_launch_refuses_to_detach(cuda, name):
    _wrapper, _plain, launch, inputs = _grad_cases(cuda, torch.float32)[name]
    with torch.no_grad():
        assert launch(*inputs).grad_fn is None  # no grad wanted: the bare launch is fine
    needs = [inputs[0].clone().requires_grad_(), *inputs[1:]]
    with pytest.raises(RuntimeError, match="autograd"):
        launch(*needs)


LOWRANK_SHAPES = [(300, 100, 260, 12), (100, 52, 130, 10), (1024, 1024, 2736, 64),
                  (1000, 2736, 1024, 64), (64, 17, 5, 3)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", LOWRANK_SHAPES)
def test_lowrank_wgrad_kernel(cuda, dtype, shape):
    from repro_torch.kernels.lowrank_wgrad import (
        lowrank_wgrad_project, lowrank_wgrad_project_plain,
    )

    T, n, m, r = shape
    gen = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn(T, n, generator=gen, device=cuda).to(dtype)
    dy = torch.randn(T, m, generator=gen, device=cuda).to(dtype)
    v1 = torch.randn(n, r, generator=gen, device=cuda).to(dtype)
    before = lowrank_wgrad_project.launches
    a = lowrank_wgrad_project(x, dy, v1)
    assert lowrank_wgrad_project.launches == before + 1
    ref = lowrank_wgrad_project_plain(x, dy, v1)
    # relative to max |ref|: the plain version's f32 matmul sums the same
    # products in another order
    tol = 1e-4
    scale = float(ref.abs().max()) + 1e-6
    assert a.dtype == torch.float32 and a.shape == (r, m)
    assert float((a - ref).abs().max()) <= tol * scale
    assert torch.equal(a, lowrank_wgrad_project(x, dy, v1))  # no float atomics: bitwise repeat


# the bf16 kernel's edges: T not a multiple of its 64-token steps or of the
# split, m not a multiple of the 64-column tile or of 8 (element loads), n
# not a multiple of 8, r from 1 to past one 64-rank tile
LOWRANK_EDGE_SHAPES = [(1000, 256, 300, 1), (777, 100, 130, 12), (4100, 1024, 1000, 64),
                       (2000, 520, 2736, 200), (8191, 64, 1030, 64)]


@pytest.mark.parametrize("shape", LOWRANK_EDGE_SHAPES)
def test_lowrank_wgrad_bf16_tile_edges_bitwise_repeatable(cuda, shape):
    from repro_torch.kernels.lowrank_wgrad import (
        lowrank_wgrad_project, lowrank_wgrad_project_plain,
    )

    T, n, m, r = shape
    gen = torch.Generator(device=cuda).manual_seed(T + r)
    x = torch.randn(T, n, generator=gen, device=cuda).to(torch.bfloat16)
    dy = torch.randn(T, m, generator=gen, device=cuda).to(torch.bfloat16)
    v1 = torch.randn(n, r, generator=gen, device=cuda).to(torch.bfloat16)
    a = lowrank_wgrad_project(x, dy, v1)
    ref = lowrank_wgrad_project_plain(x, dy, v1)
    assert a.dtype == torch.float32 and a.shape == (r, m)
    assert float((a - ref).abs().max()) <= 1e-4 * (float(ref.abs().max()) + 1e-6)
    for _ in range(3):
        assert torch.equal(a, lowrank_wgrad_project(x, dy, v1))


def test_train_step_kernels_match_plain_on_the_card(cuda):
    from repro_torch.configs.base import MeCeFOConfig, TrainConfig, get_config, reduced
    from repro_torch.core.lowrank import refresh_projections
    from repro_torch.core.ndb import NDBContext, NDBPlan, plan_to_masks
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import plain_versions
    from repro_torch.kernels.lowrank_wgrad import lowrank_wgrad_project
    from repro_torch.launch.state import init_state
    from repro_torch.launch.steps import loss_and_grads, to_device
    from repro_torch.models.model import ExecFlags
    from repro_torch.models.params import tree_leaves

    cfg = reduced(get_config("llama-350m"), dtype="float32", n_kv_heads=2)
    mecefo = MeCeFOConfig(mode="dynamic", rank=8)
    state = init_state(cfg, TrainConfig(), mecefo, torch.Generator(device=cuda).manual_seed(0),
                       device=cuda)
    proj = refresh_projections(state.params, cfg, 8)
    keep, w = plan_to_masks(NDBPlan(4, 2, frozenset({(1, 0)})), cfg, 8)
    batch = to_device(SyntheticLM(cfg.vocab_size).batch(0, 8, 64), cuda)
    for mode in ("off", "dynamic", "static", "degraded"):
        masks = {"keep": torch.as_tensor(keep, device=cuda),
                 "example_weight": torch.as_tensor(w, device=cuda)} if mode in ("dynamic", "static") else {}
        ctx = NDBContext(mode=mode, mecefo=mecefo, **masks)
        before = lowrank_wgrad_project.launches
        lk, _, gk = loss_and_grads(state.params, proj, batch, cfg, ctx, ExecFlags(ce_chunk=32))
        assert lowrank_wgrad_project.launches - before == (0 if mode == "off" else 3 * cfg.n_layers)
        with plain_versions():
            lp, _, gp = loss_and_grads(state.params, proj, batch, cfg, ctx,
                                       ExecFlags(ce_chunk=32))
        torch.testing.assert_close(lk, lp, rtol=1e-5, atol=1e-5)
        for a, b in zip(tree_leaves(gk), tree_leaves(gp)):
            assert float((a - b).norm()) <= 1e-4 * float(b.norm()) + 1e-7
