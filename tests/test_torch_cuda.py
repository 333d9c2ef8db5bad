"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests import no JAX, so they also run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Elsewhere (no card) they skip.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gridmm_tpu_torch.ops.grid_pool import (_finalize,  # noqa: E402
                                            grid_scatter_pool_raw)

B, N, D = 8, 8832, 768


def pool_case(kind: str, dtype, seed: int = 0):
    """Serving-sized pool inputs: random cells with ~5% invalid, plus an
    all-invalid batch row, a one-point cell and empty cells."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((B, N, D)).astype(np.float32)
    cells = rng.integers(0, 196, size=(B, N)).astype(np.int32)
    cells[rng.random((B, N)) < 0.05] = -1
    w = (rng.standard_normal((B, N)) * 3.0).astype(np.float32)
    if kind == "edges":
        cells[1] = -1                       # all-invalid batch row
        cells[2][cells[2] == 7] = 8         # cell 7: exactly one point
        cells[2, 100] = 7
        cells[3][cells[3] < 50] = 60        # cells 0..49 empty
    dev = "cuda"
    return (torch.from_numpy(g).to(dev, dtype), torch.from_numpy(cells).to(dev),
            torch.from_numpy(w).to(dev))


def _require_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "edges"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grid_pool_kernel_matches_plain(kind, dtype):
    """mask exact; pooled within 1e-5 x max|pooled| (f32) or one bf16 ulp of
    the largest input (bf16: 2^-8 x max|g|); denominator within 1e-5
    relative. The kernel's atomics add in a varying order, hence not 0."""
    _require_card()
    from gridmm_tpu_torch.ops.cuda.grid_pool import grid_pool_fwd

    g, cells, w = pool_case(kind, getattr(torch, dtype))
    numer, denom = grid_pool_fwd(g, cells, w)
    got_p, got_m, got_d = _finalize(numer, denom, 196)
    want_p, want_m, want_d = grid_scatter_pool_raw(g, cells, w)
    torch.cuda.synchronize()
    assert torch.equal(got_m, want_m)
    atol = (1e-5 * want_p.abs().max().item() if dtype == "float32"
            else 2.0 ** -8 * g.float().abs().max().item())
    torch.testing.assert_close(got_p, want_p, rtol=1e-5, atol=atol)
    torch.testing.assert_close(got_d, want_d, rtol=1e-5, atol=0.0)
    if kind == "edges":
        assert not got_m[1].any() and (got_p[1] == 0).all()
        assert got_m[2, 7] and not got_m[3, :50].any()
        torch.testing.assert_close(got_p[2, 7], g[2, 100].float(),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_grid_pool_kernel_counts_launches_and_rejects_bad_input():
    _require_card()
    from gridmm_tpu_torch.ops.cuda.grid_pool import GRID_POOL_FWD

    g, cells, w = pool_case("random", torch.float32)
    before = GRID_POOL_FWD.launches
    GRID_POOL_FWD(g[:2, :1000].contiguous(), cells[:2, :1000].contiguous(),
                  w[:2, :1000].contiguous())
    assert GRID_POOL_FWD.launches == before + 1
    with pytest.raises(TypeError):
        GRID_POOL_FWD(g, cells.long(), w)
    with pytest.raises(ValueError):
        GRID_POOL_FWD(g[:, ::2], cells[:, ::2], w[:, ::2])
    assert GRID_POOL_FWD.launches == before + 1


# ------------------------------------------------------------ K3 layernorm
def _ln_case(rows, c, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, c)) * 2.0 + 0.5).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.1).astype(np.float32)
    return (torch.from_numpy(x).to("cuda", dtype),
            torch.from_numpy(scale).cuda(), torch.from_numpy(bias).cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("rows,c", [(9600, 768), (1000, 64), (37, 1500),
                                    (5, 17)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_kernel_matches_plain(rows, c, dtype):
    """f32: within 1e-5 (summation order only); bf16: within one bf16 ulp
    (2^-7 relative), since both round nearly the same f32 value."""
    _require_card()
    from gridmm_tpu_torch.ops.cuda.layernorm import LAYERNORM_FWD
    from gridmm_tpu_torch.ops.layernorm import layernorm_plain

    x, scale, bias = _ln_case(rows, c, getattr(torch, dtype))
    got = LAYERNORM_FWD(x, scale, bias)
    want = layernorm_plain(x, scale, bias)
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and got.shape == x.shape
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                                   atol=1e-5)


@pytest.mark.cuda
def test_layernorm_kernel_counts_launches_and_rejects_bad_input():
    _require_card()
    from gridmm_tpu_torch.ops.cuda.layernorm import LAYERNORM_FWD

    x, scale, bias = _ln_case(64, 768, torch.float32)
    before = LAYERNORM_FWD.launches
    LAYERNORM_FWD(x, scale, bias)
    assert LAYERNORM_FWD.launches == before + 1
    with pytest.raises(TypeError):
        LAYERNORM_FWD(x.half(), scale, bias)
    with pytest.raises(ValueError):
        LAYERNORM_FWD(x[:, ::2], scale[::2], bias[::2])
    with pytest.raises(ValueError):
        LAYERNORM_FWD(x, scale[:10], bias)
    with pytest.raises(ValueError):
        LAYERNORM_FWD(x.cpu(), scale.cpu(), bias.cpu())
    assert LAYERNORM_FWD.launches == before + 1


# ------------------------------------------------------- K2 / K4 attention
def _attn_tol(dtype, v):
    """f32: 2e-5 (summation order, online softmax); bf16: the plain version
    rounds the probabilities to bf16 before PV and both round the output,
    each within 2^-8 relative (half a bf16 ulp), so the difference stays
    under 3 x 2^-8 x max|v|; the tolerance is 2^-6 x max|v|."""
    if dtype == torch.float32:
        return dict(rtol=2e-5, atol=2e-5)
    return dict(rtol=0.0, atol=2 ** -6 * v.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,heads", [(192, 50, 12), (32, 197, 12),
                                       (3, 7, 2), (2, 1, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_qkv_kernel_matches_plain(b, l, heads, dtype):
    _require_card()
    from gridmm_tpu_torch.ops.attention import attention_qkv_plain
    from gridmm_tpu_torch.ops.cuda.attention import ATTENTION_QKV_FWD

    dt = getattr(torch, dtype)
    rng = np.random.default_rng(b + l)
    qkv = torch.from_numpy(rng.standard_normal(
        (b, l, 3 * heads * 64)).astype(np.float32) * 2.0).to("cuda", dt)
    got = ATTENTION_QKV_FWD(qkv, heads)
    want = attention_qkv_plain(qkv, heads)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == dt
    torch.testing.assert_close(got.float(), want.float(),
                               **_attn_tol(dt, qkv[..., 2 * heads * 64:]))


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("l", [50, 197])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_kernel_matches_plain(hd, l, dtype):
    _require_card()
    from gridmm_tpu_torch.ops.attention import attention_plain
    from gridmm_tpu_torch.ops.cuda.attention import ATTENTION_FWD

    dt = getattr(torch, dtype)
    rng = np.random.default_rng(hd + l)
    q, k, v = (torch.from_numpy(rng.standard_normal((96, l, hd)).astype(
        np.float32) * 2.0).to("cuda", dt) for _ in range(3))
    got = ATTENTION_FWD(q, k, v)
    want = attention_plain(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **_attn_tol(dt, v))


@pytest.mark.cuda
def test_attention_dispatch_by_head_dim():
    """hd 64 goes to the packed kernel, any other hd to the per-head kernel,
    and both agree with the plain version."""
    _require_card()
    from gridmm_tpu_torch.ops.attention import (attention_qkv,
                                                attention_qkv_plain)
    from gridmm_tpu_torch.ops.cuda.attention import (ATTENTION_FWD,
                                                     ATTENTION_QKV_FWD)

    rng = np.random.default_rng(3)
    for heads, hd in ((4, 64), (4, 16)):
        qkv = torch.from_numpy(rng.standard_normal(
            (6, 50, 3 * heads * hd)).astype(np.float32)).cuda()
        before = (ATTENTION_QKV_FWD.launches, ATTENTION_FWD.launches)
        got = attention_qkv(qkv, heads)
        after = (ATTENTION_QKV_FWD.launches, ATTENTION_FWD.launches)
        assert after == ((before[0] + 1, before[1]) if hd == 64
                         else (before[0], before[1] + 1))
        torch.testing.assert_close(got, attention_qkv_plain(qkv, heads),
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_attention_kernels_count_launches_and_reject_bad_input():
    _require_card()
    from gridmm_tpu_torch.ops.cuda.attention import (ATTENTION_FWD,
                                                     ATTENTION_QKV_FWD)

    qkv = torch.zeros((2, 50, 3 * 4 * 64), device="cuda")
    q = torch.zeros((8, 50, 16), device="cuda")
    before = (ATTENTION_QKV_FWD.launches, ATTENTION_FWD.launches)
    ATTENTION_QKV_FWD(qkv, 4)
    ATTENTION_FWD(q, q, q)
    assert (ATTENTION_QKV_FWD.launches, ATTENTION_FWD.launches) == (
        before[0] + 1, before[1] + 1)
    with pytest.raises(ValueError):               # head_dim 32
        ATTENTION_QKV_FWD(torch.zeros((2, 50, 3 * 4 * 32), device="cuda"), 4)
    with pytest.raises(TypeError):
        ATTENTION_QKV_FWD(qkv.half(), 4)
    with pytest.raises(ValueError):               # not contiguous
        ATTENTION_QKV_FWD(qkv.transpose(0, 1), 4)
    with pytest.raises(ValueError):               # K and V overflow smem
        ATTENTION_QKV_FWD(torch.zeros((1, 1000, 3 * 64), device="cuda"), 1)
    with pytest.raises(ValueError):               # hd 48 unsupported
        ATTENTION_FWD(*(torch.zeros((8, 50, 48), device="cuda"),) * 3)
    with pytest.raises(ValueError):               # shapes differ
        ATTENTION_FWD(q, q[:4], q)
    with pytest.raises(ValueError):
        ATTENTION_FWD(q.cpu(), q.cpu(), q.cpu())
    assert (ATTENTION_QKV_FWD.launches, ATTENTION_FWD.launches) == (
        before[0] + 1, before[1] + 1)
