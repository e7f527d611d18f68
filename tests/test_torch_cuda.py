"""The CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and ``nvcc`` (the kernels are built from
``src/repro_torch/csrc`` at first use); elsewhere they skip.  On a machine
with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 1e-5 (the kernels and the plain versions sum in other
orders), bf16 one bf16 ulp relative (2^-7) plus 1e-2 absolute for values
rounded on either side of a bf16 boundary.
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
@pytest.mark.parametrize("case", [(2, 48, 4, 2, 32), (1, 100, 16, 8, 128), (3, 17, 4, 4, 64)])
def test_flash_attention_kernel(cuda, dtype, case):
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    B, S, H, KV, hd = case
    gen = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn(B, S, H, hd, generator=gen, device=cuda).to(dtype)
    k = torch.randn(B, S, KV, hd, generator=gen, device=cuda).to(dtype)
    v = torch.randn(B, S, KV, hd, generator=gen, device=cuda).to(dtype)
    _close(flash_attention(q, k, v), flash_attention_plain(q, k, v), dtype)


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


def test_engine_goes_through_every_kernel(cuda):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_decode import paged_decode
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.swiglu import swiglu
    from repro_torch.serve import run

    wrappers = (rmsnorm, swiglu, flash_attention, paged_decode)
    before = [w.launches for w in wrappers]
    out = run.main(["--reduced", "--n-requests", "4", "--prompt-len", "4", "40",
                    "--new-tokens", "2", "9", "--max-slots", "2", "--pages-per-slot", "4"])
    assert out["n_completed"] == 4
    assert all(w.launches > n for w, n in zip(wrappers, before))
