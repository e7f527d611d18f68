"""The CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and ``nvcc`` (the kernels are built from
``src/repro_torch/csrc`` at first use); elsewhere they skip.  On a machine
with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 1e-5 (the kernels and the plain versions sum in other
orders), bf16 one bf16 ulp relative (2^-7) plus 1e-2 absolute for values
rounded on either side of a bf16 boundary.  Gradients through a kernel's
autograd Function are the plain version's exactly (the norm's and the
attention's backwards recompute the plain version; SwiGLU's backward kernel
takes autograd's roundings, bitwise on the card).  SwiGLU's forward equals
its plain version bitwise in both arithmetics, and its backward kernel is
within one bf16 ulp of autograd of the plain version.  Kernel #6 is held at 1e-4 relative to max |ref| in
both dtypes: both sides multiply the same operands with f32 products and
sums, and differ only in summation order (bf16: P split into two bf16
terms, ~2^-17 relative).  The bf16 flash attention is also held within
half a bf16 ulp of the f32 function plus ``ROUND_SLACK`` of the magnitude
of its terms (``kernels/flash_attention.py:rounding_ratio``).
"""
import json

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


# the main path's rows (the decode round's (8, 1024), (128, 128), (64, 128);
# the prefill's (2048, 1024), (32768, 128)), the other register widths
# (2048, 4096), widths of the general paths (96, 100; 18432 a block a row)
# and row counts that leave a block part empty
RMSNORM_SHAPES = [(37, 96), (64, 1024), (33, 128), (5, 100), (8, 1024), (128, 128), (64, 128),
                  (2048, 1024), (32768, 128), (3, 2048), (7, 4096), (3, 18432), (1, 128)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", RMSNORM_SHAPES)
def test_rmsnorm_kernel(cuda, dtype, shape):
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain

    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    s = torch.randn(shape[-1], generator=g, device=cuda).to(dtype)
    n = rmsnorm.launches
    _close(rmsnorm(x, s), rmsnorm_plain(x, s), dtype)
    assert rmsnorm.launches == n + 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [128, 1024, 96, 4096])
def test_rmsnorm_kernel_batch_invariant(cuda, dtype, d):
    """A row's output is bitwise the same alone, among 2047 others and at
    another place in the batch (the engine's determinism contract)."""
    from repro_torch.kernels.rmsnorm import rmsnorm

    g = torch.Generator(device=cuda).manual_seed(d)
    x = torch.randn(2048, d, generator=g, device=cuda).to(dtype)
    s = torch.randn(d, generator=g, device=cuda).to(dtype)
    full = rmsnorm(x, s)
    assert torch.equal(full[:8], rmsnorm(x[:8].contiguous(), s))
    assert torch.equal(full[5:6], rmsnorm(x[5:6].contiguous(), s))
    assert torch.equal(full[1000:1013], rmsnorm(x[1000:1013].contiguous(), s))


# the split form's rows: mamba2's gate_norm cut over M = 2 (a step's 2048
# rows, a decode's 4), a rank's width at M = 4, and widths off the vectors
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,d_whole", [((2048, 2560), 5120), ((4, 2560), 5120),
                                           ((33, 1280), 5120), ((5, 100), 300), ((3, 7), 14)])
def test_rmsnorm_split_kernels(cuda, dtype, shape, d_whole):
    """#3's split form: each pass against its plain version, both launched
    once, and the passes over the ranks' pieces equal to the whole row's
    norm; under grad the gradients are the plain composition's."""
    from repro_torch.kernels.rmsnorm import (
        rmsnorm_apply, rmsnorm_apply_plain, rmsnorm_plain, rmsnorm_sumsq, rmsnorm_sumsq_plain,
    )

    g = torch.Generator(device=cuda).manual_seed(shape[1])
    M = d_whole // shape[1]
    xs = [torch.randn(shape, generator=g, device=cuda).to(dtype) for _ in range(M)]
    scale = torch.randn(d_whole, generator=g, device=cuda).to(dtype)
    n1, n2 = rmsnorm_sumsq.launches, rmsnorm_apply.launches
    parts = [rmsnorm_sumsq(x) for x in xs]
    for x, ss in zip(xs, parts):
        torch.testing.assert_close(ss, rmsnorm_sumsq_plain(x), atol=1e-5, rtol=1e-5)
    ss = sum(parts)
    ys = [rmsnorm_apply(x, ss, sc, d_whole) for x, sc in zip(xs, scale.chunk(M))]
    for x, sc, y in zip(xs, scale.chunk(M), ys):
        _close(y, rmsnorm_apply_plain(x, ss, sc, d_whole), dtype)
    assert (rmsnorm_sumsq.launches, rmsnorm_apply.launches) == (n1 + M, n2 + M)
    _close(torch.cat(ys, -1), rmsnorm_plain(torch.cat(xs, -1), scale), dtype)
    x = xs[0].clone().requires_grad_()
    sc = scale.chunk(M)[0].clone().requires_grad_()
    dy = torch.randn(shape, generator=g, device=cuda).to(dtype)
    y = rmsnorm_apply(x, rmsnorm_sumsq(x) + ss - parts[0], sc, d_whole)
    gx, gs = torch.autograd.grad(y, (x, sc), dy)
    xp, sp = x.detach().requires_grad_(), sc.detach().requires_grad_()
    yp = rmsnorm_apply_plain(xp, rmsnorm_sumsq_plain(xp) + ss - parts[0], sp, d_whole)
    px, ps = torch.autograd.grad(yp, (xp, sp), dy)
    _close(gx, px, dtype)
    _close(gs, ps, dtype)


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
                                  (2, 256, 16, 16, 64), (2, 130, 32, 32, 96),
                                  (2, 130, 24, 2, 192), (1, 70, 48, 1, 128)])
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
FLASH_EDGE_HEADS = [(hd, g) for hd in (32, 64, 96, 128, 192) for g in (1, 2, 4)]


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


# split-KV edges: with SPLIT_BLOCKS blocks a split, lengths at and around a
# split's end (in rows: SPLIT_BLOCKS * block), one row, a lane of many
# splits, and a Smax (1000) that is no multiple of a split or of a block
def _split_lens(block: int, smax: int) -> list:
    from repro_torch.kernels.flash_decode import SPLIT_BLOCKS

    span = SPLIT_BLOCKS * block
    return sorted({min(n, smax) for n in (0, 1, span - 1, span, span + 1, 2 * span + 1,
                                          smax - 1, smax)})


def _dense_case(dev, dtype, B, smax, H=16, KV=8, hd=128, seed=9):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, 1, H, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, smax, KV, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, smax, KV, hd, generator=gen, device=dev).to(dtype)
    return q, k, v


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block_k", [16, 32, 64, 128])
def test_flash_decode_split_edges(cuda, dtype, block_k):
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain

    smax = 1000
    lens = torch.tensor(_split_lens(block_k, smax), dtype=torch.int32, device=cuda)
    q, k, v = _dense_case(cuda, dtype, len(lens), smax)
    out = flash_decode(q, k, v, lens, block_k=block_k)
    _close(out, flash_decode_plain(q, k, v, lens), dtype)
    zero = lens == 0
    assert torch.equal(out[zero], torch.zeros_like(out[zero]))
    assert torch.equal(out, flash_decode(q, k, v, lens, block_k=block_k))  # bitwise repeat


# (H, KV, hd): G = 2, 1, 4 take the kernels' instantiations for their group
# size, G = 3 the general one; then the repo's configs' decode heads, one
# chip's share: glm4-9b and qwen3-moe (G 16 in sub-groups of 8),
# granite-34b (G 48), nemotron-4-340b (hd 192, G 12 in sub-groups of 4),
# phi-3-vision (hd 96), and G 5 at hd 192 (the general one, 960 wide)
DECODE_HEADS = [(16, 8, 128), (8, 8, 64), (16, 4, 32), (12, 4, 64), (32, 2, 128), (48, 1, 128),
                (24, 2, 192), (32, 32, 96), (10, 2, 192)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("heads", DECODE_HEADS)
def test_split_decode_kernels_bitwise_equal_at_split_edges(cuda, dtype, heads):
    """#1 against its plain version at split edges; #5 over the gathered
    view with block_k == page_size bitwise equal to it; both repeatable."""
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.paged_decode import paged_decode, paged_decode_plain

    H, KV, hd = heads
    ps, P = 16, 63
    lens = torch.tensor(_split_lens(ps, P * ps), dtype=torch.int32, device=cuda)
    B, n_pages = len(lens), 1 + len(lens) * P
    gen = torch.Generator(device=cuda).manual_seed(10)
    q = torch.randn(B, 1, H, hd, generator=gen, device=cuda).to(dtype)
    kp = torch.randn(n_pages, ps, KV, hd, generator=gen, device=cuda).to(dtype)
    vp = torch.randn(n_pages, ps, KV, hd, generator=gen, device=cuda).to(dtype)
    tables = (torch.randperm(n_pages - 1, generator=gen, device=cuda) + 1).reshape(B, P)
    tables = tables.to(torch.int32)
    out = paged_decode(q, kp, vp, tables, lens)
    _close(out, paged_decode_plain(q, kp, vp, tables, lens), dtype)
    assert torch.equal(out, paged_decode(q, kp, vp, tables, lens))
    kd = kp[tables.long()].reshape(B, P * ps, KV, hd)
    vd = vp[tables.long()].reshape(B, P * ps, KV, hd)
    assert torch.equal(flash_decode(q, kd, vd, lens, block_k=ps), out)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("heads", [(16, 8, 128), (32, 2, 128), (48, 1, 128), (24, 2, 192),
                                   (32, 32, 96)])
def test_split_decode_kernels_batch_invariant(cuda, dtype, heads):
    """Each lane decoded alone (B = 1) gives bitwise what it gives among the
    other lanes, through #1 and through #5."""
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.paged_decode import paged_decode

    H, KV, hd = heads
    ps, P = 16, 64
    lens = torch.tensor([0, 1, 15, 16, 17, 300, 777, 1024], dtype=torch.int32, device=cuda)
    B, n_pages = len(lens), 1 + len(lens) * P
    q, kd, vd = _dense_case(cuda, dtype, B, P * ps, H=H, KV=KV, hd=hd, seed=11)
    gen = torch.Generator(device=cuda).manual_seed(12)
    kp = torch.randn(n_pages, ps, KV, hd, generator=gen, device=cuda).to(dtype)
    vp = torch.randn(n_pages, ps, KV, hd, generator=gen, device=cuda).to(dtype)
    tables = (torch.randperm(n_pages - 1, generator=gen, device=cuda) + 1).reshape(B, P)
    tables = tables.to(torch.int32)
    dense = flash_decode(q, kd, vd, lens, block_k=ps)
    paged = paged_decode(q, kp, vp, tables, lens)
    for b in range(B):
        one = slice(b, b + 1)
        assert torch.equal(flash_decode(q[one], kd[one], vd[one], lens[one], block_k=ps),
                           dense[one]), b
        assert torch.equal(paged_decode(q[one], kp, vp, tables[one], lens[one]), paged[one]), b


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("heads", [(16, 8, 128), (32, 2, 128), (48, 1, 128), (24, 2, 192),
                                   (32, 32, 96), (4, 2, 32)])
def test_int8_page_walk_kernel(cuda, dtype, heads):
    """The int8 walk against its plain version (dequantized pages through
    the plain paged decode), each lane alone bitwise equal to it among the
    others, length-0 lanes exactly 0, and pages past every length (here
    scaled by NaN) never read."""
    from repro_torch.kernels.kvquant import quantize_pages
    from repro_torch.kernels.paged_decode_q8 import paged_decode_q8, paged_decode_q8_plain

    H, KV, hd = heads
    ps, P = 16, 64
    lens = torch.tensor([0, 1, 15, 16, 17, 300, 777, 1024], dtype=torch.int32, device=cuda)
    B, n_pages = len(lens), 2 + len(lens) * P
    gen = torch.Generator(device=cuda).manual_seed(13)
    q = torch.randn(B, 1, H, hd, generator=gen, device=cuda).to(dtype)
    kq, ks = quantize_pages(torch.randn(n_pages, ps, KV, hd, generator=gen, device=cuda))
    vq, vs = quantize_pages(torch.randn(n_pages, ps, KV, hd, generator=gen, device=cuda))
    tables = (torch.randperm(n_pages - 2, generator=gen, device=cuda) + 2).reshape(B, P)
    tables = tables.to(torch.int32)
    tables[0] = 0
    tables[1, 1:] = 1  # past the length: a page of NaN scale
    ks[1], vs[1] = float("nan"), float("nan")
    out = paged_decode_q8(q, kq, vq, tables, lens, k_scale=ks, v_scale=vs)
    _close(out, paged_decode_q8_plain(q, kq, vq, ks, vs, tables, lens), dtype)
    assert torch.equal(out[0], torch.zeros_like(out[0])) and bool(torch.isfinite(out).all())
    for b in range(B):
        one = slice(b, b + 1)
        assert torch.equal(paged_decode_q8(q[one], kq, vq, tables[one], lens[one],
                                           k_scale=ks, v_scale=vs), out[one]), b


def test_replica_set_streams_survive_kills_on_the_card(cuda):
    """A reduced bf16 model on two replicas under two kills, with 2
    prefills a step and prefix sharing: every request emits the stream it
    emits without chaos, however each run admitted it (a forked prompt is
    computed by its unforked recipe); restores go by snapshot and by
    replay."""
    from repro_torch.serve import run
    from repro_torch.serve.trace import ServeTraceHeader

    h = dict(config="qwen3-0.6b", seed=0, n_replicas=2, ranks_per_pod=1,
             workload={"n_requests": 10, "vocab_size": 512, "seed": 1,
                       "mean_interarrival_steps": 0.5, "prompt_len": [4, 40],
                       "new_tokens": [4, 16], "shared_prefix": 8},
             dtype="bfloat16", snapshot_cadence=3,
             engine={"max_slots": 4, "page_size": 8, "pages_per_slot": 8,
                     "max_prefills_per_step": 2, "prefix_sharing": True,
                     "use_paged_kernel": True})
    ref, _ = run.run_from_header(ServeTraceHeader(**h, chaos={"kind": "none"}), device=cuda)
    got, _ = run.run_from_header(ServeTraceHeader(
        **h, chaos={"kind": "scripted", "kills": [[4, 0, 3], [9, 1, 3]]}), device=cuda)
    acct = got.accounting
    assert acct["n_restore_snapshot"] >= 1 and acct["n_restore_replay"] >= 1
    assert acct["n_prefix_hits"] >= 1
    for rid, rs in got.states.items():
        assert rs.emitted == ref.states[rid].emitted, rid


@pytest.mark.parametrize("chunk_pages", [0, 2], ids=["unchunked", "chunked"])
def test_forked_prompt_pages_bitwise_equal_the_unforked_prompts_on_the_card(cuda, chunk_pages):
    """The card's counterpart of the CPU test of the same name in
    ``tests/test_torch_serve_paths.py``: a forked prompt's pages in bf16
    bitwise those of the same prompt admitted with no prefix registry."""
    import numpy as np

    from repro_torch.serve import run
    from repro_torch.serve.engine import EngineConfig, ServeEngine
    from repro_torch.serve.request import Request, RequestState

    tcfg, tp = run.build("qwen3-0.6b", device=cuda, use_reduced=True, dtype="bfloat16")
    rng = np.random.default_rng(5)
    base = tuple(int(x) for x in rng.integers(0, tcfg.vocab_size, 16))
    other = tuple(int(x) for x in rng.integers(0, tcfg.vocab_size, 13))
    donor, prompt = (base[:8], base) if chunk_pages else (base[:13], base[:9] + other[:4])
    geom = dict(max_slots=3, page_size=4, pages_per_slot=8, prefill_chunk_pages=chunk_pages)
    got = []
    for sharing, prompts in ((True, (donor, prompt)), (False, (prompt,))):
        eng = ServeEngine(tcfg, tp, EngineConfig(**geom, prefix_sharing=sharing), device=cuda)
        states = [RequestState(Request(i, 0, p, 4)) for i, p in enumerate(prompts)]
        queue, t = list(states), 0
        while queue or eng._pending:
            eng.step_prefills(t)
            if queue:
                eng.admit_new(queue.pop(0), t)
            t += 1
        pages, _, cur_len, _ = eng.snapshot_slot(eng.slots.index(states[-1]))
        assert cur_len == len(prompt)
        got.append((pages, states[-1].emitted[0], eng.drain_stats()["n_prefix_hits"]))
    (forked, tok, hits), (whole, tok2, _) = got
    assert hits == 1 and tok == tok2
    for e, e2 in zip(forked, whole):
        for k in e:
            assert torch.equal(e[k], e2[k]), k


def test_moe_block_matches_plain_on_the_card(cuda):
    """Reduced qwen3-moe's MoE block at f32 through kernels #3 and #4
    against the plain versions on the card: the same routing, output and
    aux loss at 1e-5."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.kernels import plain_versions
    from repro_torch.kernels.swiglu import swiglu
    from repro_torch.models import moe
    from repro_torch.models.params import init_params

    cfg = reduced(get_config("qwen3-moe-30b-a3b"), dtype="float32")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    ffn = {k: v[0] for k, v in params["layers"][0]["ffn"].items()}
    x = torch.randn(2, 24, cfg.d_model, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(1))
    before = swiglu.launches
    y, aux = moe.moe_block(ffn, x, cfg)
    assert swiglu.launches == before + 1
    with plain_versions():
        yp, auxp = moe.moe_block(ffn, x, cfg)
    _close(y, yp, torch.float32)
    _close(aux, auxp, torch.float32)


def test_flash_decode_refuses_autograd(cuda):
    from repro_torch.kernels.flash_decode import flash_decode

    q = torch.randn(1, 1, 4, 32, device=cuda, requires_grad=True)
    k = torch.randn(1, 16, 2, 32, device=cuda)
    with pytest.raises(RuntimeError, match="autograd"):
        flash_decode(q, k, k, 3)
    with torch.no_grad():
        assert flash_decode(q, k, k, 3).grad_fn is None


@pytest.mark.parametrize("decode", ["paged", "dense"])
def test_engine_goes_through_every_kernel(cuda, decode, capsys):
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
    assert run.main(["--requests", "4", "--prompt-min", "4", "--prompt-max", "40",
                     "--gen-min", "2", "--gen-max", "9", "--slots", "2", "--page-size", "16",
                     "--pages-per-slot", "4"]
                    + (["--paged-kernel"] if decode == "paged" else [])) == 0
    out = json.loads(next(ln for ln in capsys.readouterr().out.splitlines()
                          if ln.startswith("{")))
    assert out["n_completed"] == 4
    assert all(w.launches > n for w, n in zip(wrappers, before))
    assert unused.launches == idle


@pytest.mark.parametrize("engine", ["paged", "dense", "chunked"])
def test_engine_stream_alone_equals_stream_among_others(cuda, engine):
    """Whole-run batch invariance on the card: each of two requests served
    alone on a fresh engine emits the token stream it emitted among 16."""
    import dataclasses

    from repro_torch.serve import run
    from repro_torch.serve.engine import EngineConfig, ServeEngine
    from repro_torch.serve.request import WorkloadSpec, build_workload

    cfg, params = run.build("qwen3-0.6b", device=cuda, use_reduced=True, dtype="bfloat16",
                            seed=0)
    spec = WorkloadSpec(n_requests=16, vocab_size=cfg.vocab_size, prompt_len=(4, 40),
                        new_tokens=(2, 20), seed=0, shared_prefix=16 if engine == "chunked"
                        else 0, n_prefix_groups=2 if engine == "chunked" else 0)
    ecfg = EngineConfig(max_slots=8, page_size=8, pages_per_slot=16,
                        use_paged_kernel=engine == "paged")
    if engine == "chunked":
        ecfg = dataclasses.replace(ecfg, prefill_chunk_pages=2, prefix_sharing=True)
    workload = build_workload(spec)
    among = run.serve(ServeEngine(cfg, params, ecfg, device=cuda), workload).streams()
    for req in (workload[0], max(workload, key=lambda r: r.max_new_tokens)):
        alone = run.serve(ServeEngine(cfg, params, ecfg, device=cuda), [req]).streams()
        assert alone[req.rid] == among[req.rid], req.rid


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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", [("rmsnorm", 2560), ("rmsnorm", 5120),
                                  ("lowrank_wgrad", (2560, 10576)), ("lowrank_wgrad", (5120, 2560))],
                         ids=["norm-d2560", "norm-d5120", "in_proj", "out_proj"])
def test_kernels_at_the_mamba2_shapes(cuda, dtype, case):
    """#3 at mamba2's d_model and d_inner (the gate norm), #6 at in_proj's
    and out_proj's (n, m) with rank 64, over 1024 rows, against their
    plain versions."""
    from repro_torch.kernels.lowrank_wgrad import (
        lowrank_wgrad_project, lowrank_wgrad_project_plain,
    )
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain

    name, dims = case
    gen = torch.Generator(device=cuda).manual_seed(9)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=cuda).to(dtype)

    if name == "rmsnorm":
        x, s = randn(1024, dims), randn(dims)
        _close(rmsnorm(x, s), rmsnorm_plain(x, s), dtype)
        return
    (n, m), T = dims, 1024
    x, dy, v1 = randn(T, n), randn(T, m), randn(n, 64)
    ref = lowrank_wgrad_project_plain(x, dy, v1)
    a = lowrank_wgrad_project(x, dy, v1)
    assert float((a - ref).abs().max()) <= 1e-4 * (float(ref.abs().max()) + 1e-6)


def _bf16_ulps(a, b):
    ref = b.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
    return float(((a.float() - b.float()).abs() / torch.exp2(torch.floor(torch.log2(ref)) - 7))
                 .max())


def _swiglu_inputs(dev, dtype, shape, offset=0):
    """g ~ 3 N(0, 1), u and dy ~ N(0, 1); ``offset`` elements into a larger
    buffer, so that an odd offset gives views that are not 16-byte aligned
    (the kernels' scalar path)."""
    gen = torch.Generator(device=dev).manual_seed(7)
    n = 1
    for s in shape:
        n *= s
    scale = (3.0, 1.0, 1.0)
    return [(sc * torch.randn(n + offset, generator=gen, device=dev)).to(dtype)[offset:]
            .view(shape) for sc in scale]


@pytest.mark.parametrize("round_silu", [False, True], ids=["pallas", "trunk"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,offset", [((1024, 768), 0), ((37, 100), 0), ((3, 7), 0),
                                          ((8, 3072), 1), ((129, 33), 3)])
def test_swiglu_forward_and_backward_kernels(cuda, dtype, round_silu, shape, offset):
    """Both kernels in both arithmetics: the forward bitwise its plain
    version, the backward within TOL and one bf16 ulp of autograd of the
    plain version; odd tails and views off 16-byte alignment."""
    from repro_torch.kernels import swiglu as sg

    g, u, dy = _swiglu_inputs(cuda, dtype, shape, offset)
    assert (g.data_ptr() % 16 != 0) == (offset != 0)
    n = (sg.swiglu.launches, sg.swiglu_bwd.launches)
    assert torch.equal(sg.swiglu(g, u, round_silu=round_silu), sg.swiglu_plain(g, u, round_silu))
    a = [g.clone().requires_grad_(), u.clone().requires_grad_()]
    want = torch.autograd.grad(sg.swiglu_plain(*a, round_silu), a, dy)
    got = sg.swiglu_bwd(g, u, dy, round_silu)
    assert (sg.swiglu.launches, sg.swiglu_bwd.launches) == (n[0] + 1, n[1] + 1)
    for x, w in zip(got, want):
        _close(x, w, dtype)
        if dtype == torch.bfloat16:
            assert _bf16_ulps(x, w) <= 1.0


@pytest.mark.parametrize("round_silu", [False, True], ids=["pallas", "trunk"])
def test_swiglu_function_backward_is_the_kernel(cuda, round_silu):
    """Through SwiGLUFn the backward launches swiglu_bwd once and never
    the forward again; under plain_versions() neither kernel launches."""
    from repro_torch.kernels import plain_versions
    from repro_torch.kernels import swiglu as sg

    g, u, dy = _swiglu_inputs(cuda, torch.bfloat16, (64, 256))
    a = [t.clone().requires_grad_() for t in (g, u)]
    y = sg.swiglu(*a, round_silu=round_silu)
    n = (sg.swiglu.launches, sg.swiglu_bwd.launches)
    got = torch.autograd.grad(y, a, dy)
    assert (sg.swiglu.launches, sg.swiglu_bwd.launches) == (n[0], n[1] + 1)
    with plain_versions():
        b = [t.clone().requires_grad_() for t in (g, u)]
        want = torch.autograd.grad(sg.swiglu(*b, round_silu=round_silu), b, dy)
    assert (sg.swiglu.launches, sg.swiglu_bwd.launches) == (n[0], n[1] + 1)
    for x, w in zip(got, want):
        _close(x, w, torch.bfloat16)


@pytest.mark.parametrize("dtype", DTYPES)
def test_swiglu_waits_for_the_product_before_it(cuda, dtype):
    """Programmatic dependent launch: g and u come from matrix products
    issued just before the kernels, with no sync between; the results are
    bitwise those of the same calls after torch.cuda.synchronize()."""
    from repro_torch.kernels import swiglu as sg

    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(4096, 1024, generator=gen, device=cuda).to(dtype)
    w1, w2 = (torch.randn(1024, 2736, generator=gen, device=cuda).to(dtype) for _ in range(2))
    torch.cuda.synchronize()
    for _ in range(3):
        g, u = x @ w1, x @ w2
        y = sg.swiglu(g, u, round_silu=True)
        dg, du = sg.swiglu_bwd(g, u, x @ w1, True)
        torch.cuda.synchronize()
        assert torch.equal(y, sg.swiglu(g, u, round_silu=True))
        dg2, du2 = sg.swiglu_bwd(g, u, x @ w1, True)
        assert torch.equal(dg, dg2) and torch.equal(du, du2)


@pytest.mark.parametrize("dtype", DTYPES)
def test_zero_element_calls_launch_nothing(cuda, dtype):
    """mamba2's zero-width FFN: #4 on (T, 0) and #6 with m = 0 or n = 0
    (rank 0) return their empty or zero results without a launch (a grid of
    zero blocks is an invalid launch) and without an error; so does #3 on
    zero rows."""
    from repro_torch.kernels.lowrank_wgrad import lowrank_wgrad_project
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.swiglu import swiglu, swiglu_bwd

    def z(*shape):
        return torch.zeros(*shape, device=cuda, dtype=dtype)

    counts = (rmsnorm.launches, swiglu.launches, swiglu_bwd.launches,
              lowrank_wgrad_project.launches)
    assert swiglu(z(64, 0), z(64, 0)).shape == (64, 0)
    assert [t.shape for t in swiglu_bwd(z(64, 0), z(64, 0), z(64, 0))] == [(64, 0)] * 2
    assert rmsnorm(z(0, 256), z(256)).shape == (0, 256)
    a = lowrank_wgrad_project(z(64, 256), z(64, 0), z(256, 0))
    b = lowrank_wgrad_project(z(64, 0), z(64, 256), z(0, 0))
    torch.cuda.synchronize()
    assert a.shape == (0, 0) and b.shape == (0, 256) and not b.any()
    assert (rmsnorm.launches, swiglu.launches, swiglu_bwd.launches,
            lowrank_wgrad_project.launches) == counts


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


def test_snapshot_staging_holds_the_state_at_its_step(monkeypatch):
    """Live state transfer on the card (``statexfer/snapshot.py``): the
    state is updated in place on the training stream right after
    ``maybe_snapshot`` returns, while the snapshot worker is held back;
    the host snapshot must still equal the state at the call, bit for bit,
    and lie in page-locked host memory.  Needs the card, not the kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    import threading

    from repro_torch.statexfer import SnapshotManager, snapshot as tsnap

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    state = {"w": torch.randn(1 << 22, device=dev, generator=g),
             "h": torch.randn(4096, 256, device=dev, generator=g).to(torch.bfloat16), "step": 3}
    want = {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in state.items()}
    go, entered = threading.Event(), threading.Event()
    real = tsnap._to_host

    def held(staged, events):
        entered.set()
        assert go.wait(60)
        return real(staged, events)

    monkeypatch.setattr(tsnap, "_to_host", held)
    mgr = SnapshotManager(cadence=1)
    assert mgr.maybe_snapshot(state, 3, [0])
    assert entered.wait(60)
    for _ in range(8):  # the next steps, queued on the training stream
        state["w"].mul_(1.5).add_(1.0)
        state["h"].add_(1.0)
    go.set()
    mgr.wait()
    snap = mgr.latest(0).tree
    assert snap["step"] == 3 and snap["w"].is_pinned() and snap["h"].dtype == torch.bfloat16
    for k in ("w", "h"):
        assert torch.equal(snap[k], want[k]), k
    assert not torch.equal(state["w"].cpu(), want["w"])
    assert mgr.blocked_s > 0


def test_one_nccl_rank_step_equals_the_one_process_step(cuda, tmp_path):
    """A one-rank NCCL mesh (``launch/dist.py``): two steps of
    ``make_train_step(..., mesh=...)``, replicated and FSDP, in degraded mode
    with ``lowrank_sync`` on a 2-layer f32 model, bitwise equal to the
    one-process step from the same state, every collective reached."""
    from repro_torch.configs.base import (
        MeCeFOConfig, ParallelConfig, ShapeConfig, TrainConfig, get_config, reduced,
    )
    from repro_torch.core.lowrank import refresh_projections
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.dist import destroy, init_process_group
    from repro_torch.launch.state import init_state, to_local
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.parallel import collectives

    cfg = reduced(get_config("llama-350m"), dtype="float32")
    mecefo = MeCeFOConfig(mode="dynamic", rank=8, lowrank_sync=True)
    shape = ShapeConfig("t", 64, 4, "train")
    base = init_state(cfg, TrainConfig(), mecefo, torch.Generator().manual_seed(0), device=cuda)
    base = base._replace(proj=refresh_projections(base.params, cfg, 8))
    batches = [SyntheticLM(cfg.vocab_size).batch(i, 4, 64) for i in range(2)]

    def fresh():
        params = tree_map(lambda t: t.clone(), base.params)
        return base._replace(params=params, opt=type(base.opt)(*(
            tree_map(torch.zeros_like, params) for _ in base.opt)))

    def run(step, state):
        for b in batches:
            state, m = step(state, b)
        return state, {k: float(v) for k, v in m.items()}

    ref, ref_m = run(make_train_step(cfg, TrainConfig(), mecefo, shape, ndb_mode="degraded",
                                     device=cuda), fresh())
    mesh = init_process_group(0, 1, init_method=f"file://{tmp_path}/nccl", backend="nccl",
                              device=cuda)
    try:
        assert mesh.comm.backend == "nccl" and mesh.comm.route == "native"
        for fsdp in (False, True):
            step = make_train_step(cfg, TrainConfig(), mecefo, shape, ndb_mode="degraded",
                                   mesh=mesh, parallel=ParallelConfig(fsdp=fsdp))
            collectives.reset_counts()
            got, m = run(step, to_local(fresh(), step.layout))
            assert m == ref_m
            for a, b in zip(tree_leaves(got.params) + tree_leaves(got.opt.m),
                            tree_leaves(ref.params) + tree_leaves(ref.opt.m)):
                assert torch.equal(a, b)
            counts = collectives.counts()
            assert any(t.startswith("lowrank:") for t in counts["all_reduce"])
            assert ("all_gather" in counts) == fsdp == ("reduce_scatter" in counts)
    finally:
        destroy()


def test_two_gloo_ranks_tensor_parallel_step_matches_one_process(cuda, tmp_path):
    """Two gloo ranks sharing the card on mesh (1, 2) (CUDA tensors, the
    ``all_reduce`` route): two steps of ``make_train_step(..., mesh=...)``
    with the attention, FFN and vocabulary cut over ``model`` in degraded
    mode with ``lowrank_sync``, every leaf gathered whole within 1e-4 of the
    one-process step's, the kernels launched at their TP-local shapes."""
    from repro_torch.launch.dist import spawn

    spawn(_tp_card_rank, 2, str(tmp_path), backend="gloo", device="cuda", model=2, timeout=600)
    got = [torch.load(tmp_path / f"tp.{r}.pt", weights_only=False) for r in range(2)]
    assert got[0]["losses"] == got[1]["losses"]
    assert got[0]["route"] == "all_reduce"
    assert max(got[0]["rel"]) <= 1e-4, max(got[0]["rel"])
    assert all(got[0]["launches"].values()), got[0]["launches"]


def _tp_card_rank(mesh, out):
    from repro_torch.configs.base import (
        MeCeFOConfig, ParallelConfig, ShapeConfig, TrainConfig, get_config, reduced,
    )
    from repro_torch.core.lowrank import refresh_projections
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.state import gather_state, init_state, to_local
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.params import tree_leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device
    cfg = reduced(get_config("llama-350m"), dtype="float32")
    mecefo = MeCeFOConfig(mode="dynamic", rank=8, lowrank_sync=True)
    shape = ShapeConfig("t", 64, 4, "train")
    base = init_state(cfg, TrainConfig(), mecefo, torch.Generator().manual_seed(0), device=dev)
    base = base._replace(proj=refresh_projections(base.params, cfg, 8))
    batches = [SyntheticLM(cfg.vocab_size).batch(i, 4, 64) for i in range(2)]

    def fresh():
        params = tree_map(lambda t: t.clone(), base.params)
        return base._replace(params=params, opt=type(base.opt)(*(
            tree_map(torch.zeros_like, params) for _ in base.opt)))

    def run(step, state):
        losses = []
        for b in batches:
            state, m = step(state, b)
            losses.append(float(m["loss"]))
        return state, losses

    ref, _ = run(make_train_step(cfg, TrainConfig(), mecefo, shape, ndb_mode="degraded",
                                 device=dev), fresh())
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.lowrank_wgrad import lowrank_wgrad_project
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.swiglu import swiglu

    wrappers = {"flash_attention": flash_attention, "swiglu": swiglu, "rmsnorm": rmsnorm,
                "lowrank_wgrad": lowrank_wgrad_project}
    for w in wrappers.values():
        w.launches = 0
    step = make_train_step(cfg, TrainConfig(), mecefo, shape, ndb_mode="degraded", mesh=mesh,
                           parallel=ParallelConfig(fsdp=False))
    got, losses = run(step, to_local(fresh(), step.layout))
    whole = gather_state(got, step.layout)
    rel = [float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
           for a, b in zip(tree_leaves(whole.params), tree_leaves(ref.params))]
    torch.save({"losses": losses, "rel": rel, "route": mesh.model_comm.route,
                "launches": {n: w.launches for n, w in wrappers.items()}},
               f"{out}/tp.{mesh.rank}.pt")
