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

from gridmm_tpu_torch.ops.grid_pool import (cell_max,  # noqa: E402
                                            grid_scatter_pool_raw)

B, N, D = 8, 8832, 768


def pool_case(kind: str, dtype, seed: int = 0, b: int = B, n: int = N,
              d: int = D):
    """Pool inputs, serving-sized by default: random cells with ~5% invalid;
    "edges" adds an all-invalid batch row, a one-point cell and empty cells;
    "skew" a row where cell 17 holds 90% of the points, and an all-invalid
    row."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((b, n, d)).astype(np.float32)
    cells = rng.integers(0, 196, size=(b, n)).astype(np.int32)
    cells[rng.random((b, n)) < 0.05] = -1
    w = (rng.standard_normal((b, n)) * 3.0).astype(np.float32)
    if kind == "edges":
        cells[1] = -1                       # all-invalid batch row
        cells[2][cells[2] == 7] = 8         # cell 7: exactly one point
        cells[2, 100] = 7
        cells[3][cells[3] < 50] = 60        # cells 0..49 empty
    if kind == "skew":
        cells[0][rng.random(n) < 0.9] = 17  # one cell holds 90% of the row
        cells[1] = -1
    dev = "cuda"
    return (torch.from_numpy(g).to(dev, dtype), torch.from_numpy(cells).to(dev),
            torch.from_numpy(w).to(dev))


def _require_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _random_case(b, n, d, dtype, seed=0, skew=False, num_cells=196):
    """(b, n, d) features in `dtype`, ids in [-1, num_cells + 2) (a few
    invalid), weights x 3; `skew`: cell 17 holds 90% of row 0."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((b, n, d)).astype(np.float32)
    cells = rng.integers(-1, num_cells + 2, size=(b, n)).astype(np.int32)
    if skew:
        cells[0][rng.random(n) < 0.9] = 17
    w = (rng.standard_normal((b, n)) * 3.0).astype(np.float32)
    return (torch.from_numpy(g).to("cuda", dtype),
            torch.from_numpy(cells).cuda(), torch.from_numpy(w).cuda())


def _assert_pool_matches_plain(got, g, cells, w, num_cells=196):
    """K1's four outputs against the plain version, with the tolerances of
    test_grid_pool_kernel_matches_plain."""
    got_p, got_m, got_d, got_x = got
    want_p, want_m, want_d = grid_scatter_pool_raw(g, cells, w, num_cells)
    torch.cuda.synchronize()
    assert got_m.dtype == torch.bool and torch.equal(got_m, want_m)
    assert torch.equal(got_x, cell_max(cells, w, num_cells))
    atol = (1e-5 * want_p.abs().max().item() if g.dtype == torch.float32
            else 2.0 ** -8 * g.float().abs().max().item())
    torch.testing.assert_close(got_p, want_p, rtol=1e-5, atol=atol)
    torch.testing.assert_close(got_d, want_d, rtol=1e-5, atol=0.0)
    assert (got_d[:, num_cells:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "edges", "skew"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [B, 4])
def test_grid_pool_kernel_matches_plain(b, kind, dtype):
    """mask exact; pooled within 1e-5 x max|pooled| (f32) or one bf16 ulp of
    the largest input (bf16: 2^-8 x max|g|); denominator within 1e-5
    relative; the cell max equal to `cell_max`, -inf for empty cells. The
    sums run in another order than the plain version's, hence not 0. B = 8
    and the serving engine's 4 slots."""
    _require_card()
    from gridmm_tpu_torch.ops.cuda.grid_pool import grid_pool_fwd

    g, cells, w = pool_case(kind, getattr(torch, dtype), b=b)
    got_p, got_m, got_d, got_x = grid_pool_fwd(g, cells, w)
    want_p, want_m, want_d = grid_scatter_pool_raw(g, cells, w)
    torch.cuda.synchronize()
    assert got_m.dtype == torch.bool and torch.equal(got_m, want_m)
    assert torch.equal(got_x, cell_max(cells, w))
    atol = (1e-5 * want_p.abs().max().item() if dtype == "float32"
            else 2.0 ** -8 * g.float().abs().max().item())
    torch.testing.assert_close(got_p, want_p, rtol=1e-5, atol=atol)
    torch.testing.assert_close(got_d, want_d, rtol=1e-5, atol=0.0)
    assert (got_d[:, 196:] == 0).all()
    if kind == "edges":
        assert not got_m[1].any() and (got_p[1] == 0).all()
        assert got_m[2, 7] and not got_m[3, :50].any()
        torch.testing.assert_close(got_p[2, 7], g[2, 100].float(),
                                   rtol=1e-6, atol=1e-6)
    if kind == "skew":
        assert not got_m[1].any() and (got_p[1] == 0).all()
        assert (got_x[1] == float("-inf")).all() and (got_d[1] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["skew", "random", "edges"])
@pytest.mark.parametrize("b", [B, 4])
def test_grid_pool_kernel_same_bits_on_every_run(b, kind, dtype):
    """No atomics and a fixed order of every sum: two runs on the same
    inputs give equal bits in all four outputs, on each kind of buffer of
    test_grid_pool_kernel_matches_plain."""
    _require_card()
    from gridmm_tpu_torch.ops.cuda.grid_pool import grid_pool_fwd

    g, cells, w = pool_case(kind, getattr(torch, dtype), seed=4, b=b)
    first = grid_pool_fwd(g, cells, w)
    second = grid_pool_fwd(g, cells, w)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,cells_n", [(2, 1000, 30, 196), (1, 37, 1500, 5),
                                           (16, 8820, 768, 196),
                                           (3, 300, 64, 256)])
def test_grid_pool_kernel_other_shapes(b, n, d, cells_n):
    """D not a multiple of 4 (scalar path) or above one slab's 1024 columns,
    N not a multiple of anything, the cell count's ends, and a batch large
    enough for several cells a block."""
    _require_card()
    from gridmm_tpu_torch.ops.cuda.grid_pool import grid_pool_fwd

    rng = np.random.default_rng(n + d)
    g = torch.from_numpy(rng.standard_normal((b, n, d)).astype(
        np.float32)).cuda()
    cells = torch.from_numpy(rng.integers(-1, cells_n + 2, size=(b, n)
                                          ).astype(np.int32)).cuda()
    w = torch.from_numpy(rng.standard_normal((b, n)).astype(
        np.float32)).cuda()
    got_p, got_m, got_d, got_x = grid_pool_fwd(g, cells, w, cells_n)
    want_p, want_m, want_d = grid_scatter_pool_raw(g, cells, w, cells_n)
    torch.cuda.synchronize()
    assert torch.equal(got_m, want_m)
    assert torch.equal(got_x, cell_max(cells, w, cells_n))
    torch.testing.assert_close(got_p, want_p, rtol=1e-5,
                               atol=1e-5 * want_p.abs().max().item())
    torch.testing.assert_close(got_d, want_d, rtol=1e-5, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,d,skew", [(2, 40000, 768, False),
                                        (4, 8832, 768, True),
                                        (65537, 4, 8, False),
                                        (1, 300000, 8, False)])
def test_grid_pool_kernel_any_row_length_and_batch(b, n, d, skew, dtype):
    """Rows past the 30,208 (and 65,535) points one block once listed (split
    over a cluster), a serving buffer with 90% of a row in one cell, more
    rows than the grid's y extent, and a row long enough that each block of
    its cluster lists its share in three chunks: against the plain
    version, and equal bits on a second run."""
    _require_card()
    from gridmm_tpu_torch.ops.cuda.grid_pool import grid_pool_fwd

    g, cells, w = _random_case(b, n, d, getattr(torch, dtype), seed=n + b,
                               skew=skew)
    got = grid_pool_fwd(g, cells, w)
    again = grid_pool_fwd(g, cells, w)
    _assert_pool_matches_plain(got, g, cells, w)
    for x, y in zip(got, again):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1, 1000), (2, 3, 777), (4, 8, 64),
                                   (3, 7, 300)])
def test_grid_pool_kernel_at_forced_launch_shapes(shape):
    """(group, row_split, chunk) forced on a skewed serving buffer: many
    chunks a block (the online rescale of the running max and sums), odd
    cluster sizes and cell groups that do not divide 196."""
    _require_card()
    from gridmm_tpu_torch.ops.cuda.grid_pool import GRID_POOL_FWD

    g, cells, w = pool_case("skew", torch.float32, seed=2)
    b, n, d = g.shape
    outs = (torch.empty((b, 196, d), device="cuda"),
            torch.empty((b, 196), dtype=torch.bool, device="cuda"),
            torch.empty((b, 256), device="cuda"),
            torch.empty((b, 196), device="cuda"))
    GRID_POOL_FWD.launch(g, cells, w, *outs, shape=shape)
    _assert_pool_matches_plain(outs, g, cells, w)


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
    # a row past the 30,208 points one block once listed: pooled like the
    # plain version (the launch counted)
    g, cells, w = _random_case(1, 60000, 4, torch.float32, seed=60)
    got_p, got_m, got_d, got_x = GRID_POOL_FWD(g, cells, w)
    assert GRID_POOL_FWD.launches == before + 2
    _assert_pool_matches_plain((got_p, got_m, got_d, got_x), g, cells, w)


# ------------------------------------------------ K5a/K5b pool backward
def _bwd_case(kind, dtype, b, n, seed=0, d=D, filled=None):
    """pool_case at (b, n, d) with a cotangent and the forward's residuals:
    a slice of the serving-sized case where (b, n, d) fits in it; the
    points past `filled` invalid, as in a buffer not yet full."""
    fits = b <= B and n <= N and d == D
    g, cells, w = pool_case(kind, dtype, seed,
                            *((B, N, D) if fits else (b, n, d)))
    g, cells, w = (g[:b, :n].contiguous(), cells[:b, :n].contiguous(),
                   w[:b, :n].contiguous())
    if filled is not None:
        cells[:, filled:] = -1
    rng = np.random.default_rng(seed + 1)
    cot = torch.from_numpy(rng.standard_normal((b, 196, g.shape[-1])).astype(
        np.float32)).cuda()
    _, _, denom = grid_scatter_pool_raw(g, cells, w)
    return g, cells, w, cell_max(cells, w), denom.contiguous(), cot


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "edges"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n", [(4, 8820), (8, 8832), (4, 8821), (3, 1001),
                                 (4, 8832), (16, 8820), (16, 8832),
                                 (16, 8821)])
def test_grid_pool_bwd_kernels_match_plain(kind, dtype, b, n):
    """dg within 1e-5 x max|dg| (f32: one product each side) or one bf16 ulp
    of its magnitude (bf16: both round the same f32 product); s within 1e-5
    and S, dw within 1e-4 of their max (S adds tile by tile, in another
    order than the plain version's). N = 8820 is the stacked buffer's
    length, not a multiple of 512; N = 8821 and 1001 are odd, so every
    other row starts off an 8-byte boundary and pass 2 takes a scalar head
    and tail. B = 16 is the train update's batch."""
    _require_card()
    from gridmm_tpu_torch.ops.cuda.grid_pool import (GRID_POOL_BWD1,
                                                     GRID_POOL_BWD2,
                                                     grid_pool_bwd)
    from gridmm_tpu_torch.ops.grid_pool import grid_pool_bwd_terms

    g, cells, w, cmax, denom, cot = _bwd_case(kind, getattr(torch, dtype),
                                              b, n)
    before = (GRID_POOL_BWD1.launches, GRID_POOL_BWD2.launches)
    got = grid_pool_bwd(g, cells, w, cmax, denom, cot)
    want = grid_pool_bwd_terms(g, cells, w, denom, cot)
    torch.cuda.synchronize()
    assert (GRID_POOL_BWD1.launches, GRID_POOL_BWD2.launches) == (
        before[0] + 1, before[1] + 1)
    assert got[0].dtype == g.dtype and got[1].dtype == torch.float32
    dg, want_dg = got[0].float(), want[0].float()
    if dtype == "float32":
        torch.testing.assert_close(dg, want_dg, rtol=0,
                                   atol=1e-5 * want_dg.abs().max().item())
    else:
        torch.testing.assert_close(dg, want_dg, rtol=2.0 ** -7, atol=1e-30)
    for name, a, ref, tol in (("dw", got[1], want[1], 1e-4),
                              ("s", got[2], want[2], 1e-5),
                              ("S", got[3], want[3], 1e-4)):
        torch.testing.assert_close(a, ref, rtol=0,
                                   atol=tol * ref.abs().max().item(),
                                   msg=lambda m, name=name: f"{name}: {m}")
    if kind == "edges":
        assert (dg[1] == 0).all() and (got[1][1] == 0).all()
        assert got[1][2, 100].abs().item() <= 1e-6   # one-point cell
        invalid = cells < 0
        assert (dg[invalid] == 0).all() and (got[1][invalid] == 0).all()


def _assert_bwd_matches_plain(got, g, cells, w, denom, cot):
    """K5a/K5b's four outputs against grid_pool_bwd_terms, with the
    tolerances of test_grid_pool_bwd_kernels_match_plain."""
    from gridmm_tpu_torch.ops.grid_pool import grid_pool_bwd_terms

    want = grid_pool_bwd_terms(g, cells, w, denom, cot)
    torch.cuda.synchronize()
    dg, want_dg = got[0].float(), want[0].float()
    if g.dtype == torch.float32:
        torch.testing.assert_close(dg, want_dg, rtol=0,
                                   atol=1e-5 * want_dg.abs().max().item())
    else:
        torch.testing.assert_close(dg, want_dg, rtol=2.0 ** -7, atol=1e-30)
    for name, a, ref, tol in (("dw", got[1], want[1], 1e-4),
                              ("s", got[2], want[2], 1e-5),
                              ("S", got[3], want[3], 1e-4)):
        torch.testing.assert_close(a, ref, rtol=0,
                                   atol=tol * ref.abs().max().item(),
                                   msg=lambda m, name=name: f"{name}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,dtype", [(2, 40000, 768, "float32"),
                                         (2, 40000, 768, "bfloat16"),
                                         (65537, 4, 8, "float32")])
def test_grid_pool_bwd_kernels_any_row_length_and_batch(b, n, d, dtype):
    """Rows past the forward's old limit and more rows than the grid's y
    extent (pass 2's old cap): both passes against the plain version."""
    _require_card()
    from gridmm_tpu_torch.ops.cuda.grid_pool import grid_pool_bwd

    g, cells, w = _random_case(b, n, d, getattr(torch, dtype), seed=b + n)
    _, _, denom = grid_scatter_pool_raw(g, cells, w)
    denom = denom.contiguous()
    cot = torch.randn((b, 196, d), device="cuda",
                      generator=torch.Generator("cuda").manual_seed(1))
    got = grid_pool_bwd(g, cells, w, cell_max(cells, w), denom, cot)
    _assert_bwd_matches_plain(got, g, cells, w, denom, cot)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,d", [(8, 8820, 768), (4, 8832, 768),
                                   (16, 8820, 768), (8, 12416, 768),
                                   (4, 11776, 768), (2, 40000, 768),
                                   (65537, 4, 8)])
def test_grid_pool_bwd_kernels_same_bits_on_every_run(b, n, d, dtype):
    """S is summed in an order fixed by the shape (no atomics): two calls
    on the same inputs give equal bits in d_fts, d_weights, s and S, at
    the main paths' shapes (serving's 4 x 8832, the train update's
    16 x 8820, pretraining's 8 x 12,416 with 12,348 filled, VLN-CE's
    4 x 11,776 with 11,760 filled: an all-invalid tail) and at
    test_grid_pool_bwd_kernels_any_row_length_and_batch's."""
    _require_card()
    from gridmm_tpu_torch.ops.cuda.grid_pool import grid_pool_bwd

    filled = {(8, 12416): 21 * 588, (4, 11776): 20 * 588}.get((b, n))
    g, cells, w, cmax, denom, cot = _bwd_case("random", getattr(torch, dtype),
                                              b, n, seed=7, d=d,
                                              filled=filled)
    first = grid_pool_bwd(g, cells, w, cmax, denom, cot)
    second = grid_pool_bwd(g, cells, w, cmax, denom, cot)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 30])
def test_grid_pool_function_on_card_matches_cpu(d):
    """The autograd pool on the card (three kernels) against the same on the
    CPU (plain versions), tiny widths: D = 64 takes the vector path, D = 30
    the scalar one. Gradients within 1e-5 of their max."""
    _require_card()
    from gridmm_tpu_torch.ops.grid_pool import grid_pool

    rng = np.random.default_rng(3)
    b, n = 2, 1000
    g = torch.from_numpy(rng.standard_normal((b, n, d)).astype(np.float32))
    cells = torch.from_numpy(rng.integers(-1, 196, size=(b, n)
                                          ).astype(np.int32))
    w = torch.from_numpy(rng.standard_normal((b, n)).astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal((b, 196, d)
                                               ).astype(np.float32))
    grads = {}
    for dev in ("cpu", "cuda"):
        gd = g.detach().to(dev, copy=True).requires_grad_()
        wd = w.detach().to(dev, copy=True).requires_grad_()
        pooled, _ = grid_pool(gd, cells.to(dev), wd)
        pooled.backward(cot.to(dev))
        grads[dev] = (gd.grad.cpu(), wd.grad.cpu())
    for a, ref in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, ref, rtol=0,
                                   atol=1e-5 * ref.abs().max().item())


@pytest.mark.cuda
def test_grid_pool_bwd2_on_arrays_off_8_byte_boundaries():
    """Cell ids and weights that start 4 bytes past an 8-byte boundary:
    pass 2 takes every point one by one; dw within 1e-4 of its max."""
    _require_card()
    from gridmm_tpu_torch.ops.cuda.grid_pool import grid_pool_bwd
    from gridmm_tpu_torch.ops.grid_pool import grid_pool_bwd_terms

    g, cells, w, cmax, denom, cot = _bwd_case("edges", torch.float32, 4, 8820)
    cells_buf = torch.empty(cells.numel() + 1, dtype=torch.int32,
                            device="cuda")
    w_buf = torch.empty(w.numel() + 1, device="cuda")
    cells_off = cells_buf[1:].view_as(cells).copy_(cells)
    w_off = w_buf[1:].view_as(w).copy_(w)
    assert cells_off.data_ptr() % 8 and w_off.data_ptr() % 8
    got = grid_pool_bwd(g, cells_off, w_off, cmax, denom, cot)
    want = grid_pool_bwd_terms(g, cells, w, denom, cot)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[1], want[1], rtol=0,
                               atol=1e-4 * want[1].abs().max().item())


@pytest.mark.cuda
def test_grid_pool_bwd_rejects_bad_input():
    _require_card()
    from gridmm_tpu_torch.ops.cuda.grid_pool import (GRID_POOL_BWD1,
                                                     grid_pool_bwd)

    g, cells, w, cmax, denom, cot = _bwd_case("random", torch.float32, 2,
                                              1000)
    before = GRID_POOL_BWD1.launches
    with pytest.raises(ValueError):
        grid_pool_bwd(g, cells, w, cmax, denom[:, :196].contiguous(), cot)
    with pytest.raises(ValueError):
        grid_pool_bwd(g, cells, w, cmax, denom, cot.double())
    with pytest.raises(ValueError):
        grid_pool_bwd(g.cpu(), cells, w, cmax, denom, cot)
    assert GRID_POOL_BWD1.launches == before


# ------------------------------------------------------------ K3 layernorm
def _ln_case(rows, c, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, c)) * 2.0 + 0.5).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.1).astype(np.float32)
    return (torch.from_numpy(x).to("cuda", dtype),
            torch.from_numpy(scale).cuda(), torch.from_numpy(bias).cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("rows,c", [(9600, 768), (1000, 64), (2400, 64),
                                    (37, 1500), (5, 17), (1001, 40),
                                    (333, 520), (3, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_kernel_matches_plain(rows, c, dtype):
    """f32: within 1e-5 (summation order only); bf16: within one bf16 ulp
    (2^-7 relative), since both round nearly the same f32 value. The widths
    reach every body: the vector body with a whole warp a row (768, 520)
    and with part of a warp (64, 40, 8); the scalar bodies where C is no
    multiple of the vector width (17; 1500 in bf16) or wider than the
    vector body holds (1500 in f32)."""
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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_kernel_off_16_byte_boundary(dtype):
    """An x that starts three elements past a 16-byte boundary runs the
    scalar body; same tolerances as above."""
    _require_card()
    from gridmm_tpu_torch.ops.cuda.layernorm import LAYERNORM_FWD
    from gridmm_tpu_torch.ops.layernorm import layernorm_plain

    rows, c = 600, 768
    x, scale, bias = _ln_case(rows, c, getattr(torch, dtype), seed=2)
    buf = torch.empty(rows * c + 3, dtype=x.dtype, device="cuda")
    x_off = buf[3:].view(rows, c).copy_(x)
    assert x_off.data_ptr() % 16
    got = LAYERNORM_FWD(x_off, scale, bias)
    want = layernorm_plain(x, scale, bias)
    torch.cuda.synchronize()
    rtol = 1e-5 if dtype == "float32" else 2 ** -7
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
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
                                       (3, 7, 2), (2, 1, 1), (5, 17, 3),
                                       (4, 64, 2), (2, 65, 12), (1, 400, 1),
                                       (3, 129, 2), (2, 193, 3),
                                       (4, 1025, 12), (2, 2048, 12),
                                       (1, 5000, 2), (8, 1, 12), (8, 17, 12),
                                       (8, 64, 12)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_qkv_kernel_matches_plain(b, l, heads, dtype):
    """bf16 runs on the tensor cores, f32 on the CUDA cores; L = 1, 17, 64
    and 65 sit on the edges of the 16-key and 64-key tiles, 129 and 193 on
    those of a bf16 block's query rows (5 and 7 warps) and past its ring
    of two tiles; at L = 1025, 2048 and 5000 K and V stream through the
    ring many times over."""
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


# K4's cases: every padded width of both bodies and the edges of the 16-key
# and 64-query tiles (L = 1, 17, 50, 197), and ViT-H/14's (257, 80); K and
# V streamed through the ring (L = 700, 1025, 2048 where a slice's tiles
# outgrow it); hd above 256 (the wide kernels, 128 output columns a work
# item, K in 128-column chunks: 257, 320, 500 and 1024)
ATTN_CASES = ([(hd, l) for hd in (1, 16, 20, 48, 64, 80, 128, 200, 256)
               for l in (1, 17, 50, 197)] + [(80, 257)]
              + [(hd, 700) for hd in (16, 48, 80, 128, 200, 256)]
              + [(1, 1025), (80, 1025), (64, 2048)]
              + [(hd, l) for hd in (257, 320, 500, 1024)
                 for l in (1, 17, 60, 600)])


@pytest.mark.cuda
@pytest.mark.parametrize("hd,l", ATTN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_kernel_matches_plain(hd, l, dtype):
    """Inputs at scale 2.0 give peaked softmaxes, so a fragment read from
    the wrong lane shows."""
    _require_card()
    from gridmm_tpu_torch.ops.attention import attention_plain
    from gridmm_tpu_torch.ops.cuda.attention import ATTENTION_FWD

    dt = getattr(torch, dtype)
    rng = np.random.default_rng(hd + l)
    q, k, v = (torch.from_numpy(rng.standard_normal((24, l, hd)).astype(
        np.float32) * 2.0).to("cuda", dt) for _ in range(3))
    before = ATTENTION_FWD.launches
    got = ATTENTION_FWD(q, k, v)
    want = attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert ATTENTION_FWD.launches == before + 1
    assert got.shape == want.shape and got.dtype == dt
    torch.testing.assert_close(got.float(), want.float(), **_attn_tol(dt, v))


# (slices, L, hd) of K4 at other slice counts than ATTN_CASES's 24: more
# slices than blocks in flight; every padded width at the tiles' edges and
# ViT-H/14's (257, 80) on 768 slices; the ring and the wide kernels on 64
# and 16 slices
SLICE_CASES = ([(3000, 17, 20), (3000, 50, 64), (1000, 197, 200),
                (600, 400, 80), (200, 150, 320)]
               + [(768, l, hd) for hd in (1, 16, 20, 48, 64, 80, 128, 200, 256)
                  for l in (1, 17, 50, 197)] + [(768, 257, 80)]
               + [(64, 1025, 80), (64, 1025, 1), (64, 700, 256),
                  (16, 600, 320), (16, 17, 320), (16, 60, 1024)])


@pytest.mark.cuda
@pytest.mark.parametrize("bh,l,hd", SLICE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_kernel_many_slices(bh, l, hd, dtype):
    """Where the persistent grid holds fewer blocks than there are work
    items, a bf16 block walks several (with the next one's K and V staged
    behind at L = 17 and 50, and streamed through its ring at L = 400), an
    f32 block several slices at L = 17; the wide kernels many (slice,
    share, query rows) items. The other slice counts of SLICE_CASES change
    how many items each block of the grid walks."""
    _require_card()
    from gridmm_tpu_torch.ops.attention import attention_plain
    from gridmm_tpu_torch.ops.cuda.attention import ATTENTION_FWD

    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(bh + l)
    q, k, v = ((2.0 * torch.randn((bh, l, hd), generator=gen,
                                  device="cuda")).to(dt) for _ in range(3))
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
    for heads, hd in ((4, 64), (4, 16), (2, 80)):
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
    with pytest.raises(ValueError):               # shapes differ
        ATTENTION_FWD(q, q[:4], q)
    with pytest.raises(ValueError):
        ATTENTION_FWD(q.cpu(), q.cpu(), q.cpu())
    assert (ATTENTION_QKV_FWD.launches, ATTENTION_FWD.launches) == (
        before[0] + 1, before[1] + 1)
    for hd in (48, 80):                           # any hd up to 256
        x = torch.zeros((8, 50, hd), device="cuda")
        ATTENTION_FWD(x, x, x)
    assert (ATTENTION_QKV_FWD.launches, ATTENTION_FWD.launches) == (
        before[0] + 1, before[1] + 3)
    # K and V past what shared memory once held, and hd above 256: refused
    # before K and V streamed through a ring; now they run, and match the
    # plain versions
    from gridmm_tpu_torch.ops.attention import (attention_plain,
                                                attention_qkv_plain)
    rng = np.random.default_rng(1000)
    long = torch.from_numpy(rng.standard_normal((1, 1000, 3 * 64)).astype(
        np.float32)).cuda()
    torch.testing.assert_close(ATTENTION_QKV_FWD(long, 1),
                               attention_qkv_plain(long, 1),
                               **_attn_tol(torch.float32, long))
    wide = [torch.from_numpy(rng.standard_normal((8, 50, 257)).astype(
        np.float32)).cuda() for _ in range(3)]
    torch.testing.assert_close(ATTENTION_FWD(*wide), attention_plain(*wide),
                               **_attn_tol(torch.float32, wide[2]))
    assert (ATTENTION_QKV_FWD.launches, ATTENTION_FWD.launches) == (
        before[0] + 2, before[1] + 4)


@pytest.mark.cuda
def test_attention_shared_memory_mirror_matches_the_launchers():
    """ops/cuda/attention._smem_bytes, which the CPU tests check, against
    the launchers' own (`gridmm_attention_fwd_smem`,
    `gridmm_attention_qkv_fwd_smem`) at every hd up to 299 and a few above,
    in both types."""
    _require_card()
    import ctypes

    from gridmm_tpu_torch.ops.cuda import build
    from gridmm_tpu_torch.ops.cuda.attention import _smem_bytes

    per_head = build.function("attention_fwd", "gridmm_attention_fwd_smem",
                              [ctypes.c_int, ctypes.c_int])
    packed = build.function("attention_qkv_fwd",
                            "gridmm_attention_qkv_fwd_smem", [ctypes.c_int])
    for code, dtype in ((0, torch.float32), (1, torch.bfloat16)):
        assert packed(code) == _smem_bytes(50, 64, dtype, packed=True)
        for hd in [*range(1, 300), 320, 384, 500, 1024]:
            assert per_head(code, hd) == _smem_bytes(50, hd, dtype), (
                hd, dtype)


@pytest.mark.cuda
def test_fixed_order_gradients_match_torch_and_repeat_on_the_card():
    """The fused logits' gather and the embedding tables (models/layers.py)
    on the card: the values of torch.gather and nn.Embedding, gradients
    within 1e-5 of theirs (sums over repeats taken in another order), the
    same bits on a second run, and 0 in rows no id hits."""
    _require_card()
    from gridmm_tpu_torch.models.layers import Embedding, gather_fixed_order

    rng = np.random.default_rng(11)
    src = torch.from_numpy(rng.standard_normal((16, 40)).astype(
        np.float32)).cuda()
    index = torch.from_numpy(rng.integers(-8, 40, size=(16, 64))).cuda()
    index = index.clamp(min=0)
    gout = torch.from_numpy(rng.standard_normal((16, 64)).astype(
        np.float32)).cuda()
    ids = torch.from_numpy(rng.integers(0, 300, size=(16, 80))).cuda()
    eout = torch.from_numpy(rng.standard_normal((16, 80, 768)).astype(
        np.float32)).cuda()
    ref_table = torch.nn.Embedding(1000, 768).cuda()

    def grads():
        s = src.clone().requires_grad_(True)
        out = gather_fixed_order(s, index)
        out.backward(gout)
        table = Embedding(1000, 768).cuda()
        table.load_state_dict(ref_table.state_dict())
        e = table(ids)
        e.backward(eout)
        return out, s.grad, e, table.weight.grad

    out, sgrad, e, egrad = grads()
    s = src.clone().requires_grad_(True)
    want = torch.gather(s, 1, index)
    want.backward(gout)
    assert torch.equal(out, want)
    torch.testing.assert_close(sgrad, s.grad, rtol=1e-5, atol=1e-5)
    ref_table.zero_grad()
    want_e = ref_table(ids)
    want_e.backward(eout)
    assert torch.equal(e, want_e)
    torch.testing.assert_close(egrad, ref_table.weight.grad, rtol=1e-5,
                               atol=1e-5)
    assert (egrad[300:] == 0).all()
    _, sgrad2, _, egrad2 = grads()
    assert torch.equal(sgrad, sgrad2) and torch.equal(egrad, egrad2)


# ------------------------------------------ the op, the graphed step, bundles
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grid_pool_op_on_card_matches_plain(dtype):
    """`gridmm::grid_pool_fwd` on CUDA tensors launches K1 once a call and
    gives the plain version's mask, denominator and cell max, pooled within
    the kernel test's bounds; `opcheck` passes on the card too."""
    _require_card()
    from gridmm_tpu_torch.ops.cuda.grid_pool import GRID_POOL_FWD

    g, cells, w = pool_case("edges", getattr(torch, dtype), seed=4)
    before = GRID_POOL_FWD.launches
    pooled, mask, denom, cmax = torch.ops.gridmm.grid_pool_fwd(g, cells, w,
                                                                196)
    torch.cuda.synchronize()
    assert GRID_POOL_FWD.launches == before + 1
    ref = torch.ops.gridmm.grid_pool_fwd(g.cpu(), cells.cpu(), w.cpu(), 196)
    assert torch.equal(mask.cpu(), ref[1])
    assert torch.equal(cmax.cpu(), ref[3])
    torch.testing.assert_close(denom.cpu(), ref[2], rtol=1e-5, atol=0)
    tol = (1e-5 * ref[0].abs().max().item() if dtype == "float32"
           else 2.0 ** -8 * g.float().abs().max().item())
    assert (pooled.cpu() - ref[0]).abs().max().item() <= tol
    small = tuple(t[:2, :600].contiguous() for t in (g, cells, w))
    torch.library.opcheck(torch.ops.gridmm.grid_pool_fwd.default,
                          (*small, 196))


def _tiny_engine_inputs(cfg, n_req=3, steps=4, seed=0):
    from chip_smoke import request_text, step_row

    rng = np.random.default_rng(seed)
    texts = [request_text(cfg, rng) for _ in range(n_req)]
    rows = [[step_row(cfg, rng, t) for t in range(steps)]
            for _ in range(n_req)]
    return texts, rows


def _drive(eng, texts, rows, slots):
    """Admit the first `slots` requests, step them all, finish request 0,
    admit the next, step again; returns every step's outputs on the host."""
    for r, (ids, mask) in enumerate(texts):
        eng.submit(r, ids, mask)
    eng.admit()
    outs, done = [], {r: 0 for r in range(len(texts))}
    for step in range(len(rows[0])):
        if step == 2:
            eng.finish(0)
            eng.admit()
        active = eng.active()
        out = eng.step({s: rows[r][done[r]] for r, s in active.items()})
        outs.append({f: getattr(out, f).cpu() for f in
                     ("fused_logits", "global_logits", "grid_logits")})
        for r in active:
            done[r] += 1
    return outs


def _assert_outs_close(got, want):
    """Within 1e-5 x max|logit|, -inf at the same places (equal bits are
    expected: the same kernels run in the same order)."""
    for a_step, b_step in zip(got, want):
        for f, b in b_step.items():
            a = a_step[f]
            fin = torch.isfinite(b)
            assert torch.equal(torch.isfinite(a), fin), f
            scale = b[fin].abs().max().item()
            assert (a[fin] - b[fin]).abs().max().item() <= 1e-5 * scale, f


@pytest.mark.cuda
def test_graphed_serving_step_matches_eager():
    """The CUDA-graphed engine against an eager engine over the same model
    and requests; the capture records one K1 launch that every replay
    repeats."""
    _require_card()
    from gridmm_tpu_torch.config import tiny_config
    from gridmm_tpu_torch.models.navigator import init_navigator
    from gridmm_tpu_torch.serve.engine import NavServingEngine

    cfg = tiny_config()
    model = init_navigator(cfg.model, seed=2, device="cuda")
    texts, rows = _tiny_engine_inputs(cfg)
    graphed = NavServingEngine.create(model, cfg, 2)
    eager = NavServingEngine.create(model, cfg, 2, cuda_graph=False)
    assert graphed.graph_launches == {"grid_pool_fwd": 1}
    assert eager.graph_launches == {}
    _assert_outs_close(_drive(graphed, texts, rows, 2),
                       _drive(eager, texts, rows, 2))
    assert graphed.replays == len(rows[0]) and eager.replays == 0


HEADS = ("fused_logits", "global_logits", "local_logits", "grid_logits")


def _drive_admissions(eng, texts, rows, slots):
    """Submit every request, then four rounds of finishing requests,
    admitting (slots, then 1, then 3, then 0 rows) and stepping every
    active slot. Returns each step's four logit heads and the engine's
    text, mask and carry buffers after it, on the host, and the rows each
    admission encoded (`serve.admit.rows_encoded`, read under the
    profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from gridmm_tpu_torch.serve.engine import _carry_tensors
    from gridmm_tpu_torch.utils.logging import profiled_stretch, span

    with span("unprofiled") as sp:   # the profiled stretch starts anew
        assert sp is None
    for r, (ids, mask) in enumerate(texts):
        eng.submit(r, ids, mask)
    outs, done, admitted = [], {r: 0 for r in range(len(texts))}, []
    with profile(activities=[ProfilerActivity.CPU]):
        for finish in ([], [0], [1, 2, 3], []):
            for r in finish:
                eng.finish(r)
            admitted.append(len(eng.admit()))
            active = eng.active()
            out = eng.step({s: rows[r][done[r]] for r, s in active.items()})
            outs.append({f: getattr(out, f).cpu() for f in HEADS})
            outs[-1]["state"] = [t.cpu() for t in (
                eng._txt_buf, eng._mask_buf, *_carry_tensors(eng._carry))]
            for r in active:
                done[r] += 1
    assert admitted == [slots, 1, 3, 0]
    encoded = [sp.counters["serve.admit.rows_encoded"]
               for sp in profiled_stretch().named("serve.admit")]
    return outs, encoded


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_graphed_admissions_match_eager_admissions_bit_for_bit(int8):
    """A 16-slot engine that replays its admissions from CUDA graphs
    against a `cuda_graph=False` engine over the same model, admitting 16,
    1, 3 and then 0 rows: the text, mask and carry buffers and every served
    step's four logit heads are equal bit for bit. The step's graph records
    what it did before; a live engine holds a graph for each of the 16 row
    counts, an int8 engine one at 16 rows."""
    _require_card()
    import dataclasses

    from gridmm_tpu_torch.config import tiny_config
    from gridmm_tpu_torch.models.navigator import init_navigator
    from gridmm_tpu_torch.serve.engine import NavServingEngine

    cfg, slots = tiny_config(), 16
    if int8:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, int8_matmuls=True))
    model = init_navigator(cfg.model, seed=2, device="cuda")
    texts, rows = _tiny_engine_inputs(cfg, n_req=slots + 4, seed=3)
    graphed = NavServingEngine.create(model, cfg, slots)
    eager = NavServingEngine.create(model, cfg, slots, cuda_graph=False)
    assert graphed.graph_launches == {"grid_pool_fwd": 1}
    assert sorted(graphed._admit_graphs) == ([slots] if int8 else
                                             list(range(1, slots + 1)))
    assert not eager._admit_graphs
    got, encoded = _drive_admissions(graphed, texts, rows, slots)
    want, encoded_eager = _drive_admissions(eager, texts, rows, slots)
    assert encoded == encoded_eager == ([slots] * 3 if int8
                                        else [slots, 1, 3])
    for step, (a, b) in enumerate(zip(got, want)):
        for f in HEADS:
            assert torch.equal(a[f], b[f]), (step, f)
        for i, (x, y) in enumerate(zip(a["state"], b["state"])):
            assert torch.equal(x, y), (step, i)
    assert graphed.replays == 4 and eager.replays == 0


def _drive_back_to_back(eng, texts, rows, back_to_back):
    """Admit every request, then one step a row of `rows` (each request's
    rows in one set of host arrays that is overwritten as soon as `step`
    returns, with noise after the last). Back to back: the compute stream
    spins before each step, so the host enqueues the next step's copies
    while the last step has yet to run, and no output is read before the
    end; else each step's outputs are read at once. Returns each step's
    four logit heads on the host and each step's (`serve.step.h2d_bytes`,
    `serve.step.h2d_streamed_bytes`), read under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from gridmm_tpu_torch.train.step import StepInputs
    from gridmm_tpu_torch.utils.logging import profiled_stretch, span

    with span("unprofiled") as sp:   # the profiled stretch starts anew
        assert sp is None
    for r, (ids, mask) in enumerate(texts):
        eng.submit(r, ids, mask)
    eng.admit()
    slot = eng.active()
    live = {slot[r]: StepInputs(*(np.array(a) for a in rows[r][0]))
            for r in slot}
    noise = np.random.default_rng(11)
    outs = []
    with profile(activities=[ProfilerActivity.CPU]):
        for t in range(len(rows[0])):
            if back_to_back:
                torch.cuda._sleep(20_000_000)
            out = eng.step(live)
            outs.append(out if back_to_back else
                        {f: getattr(out, f).cpu() for f in HEADS})
            for r, s in slot.items():
                nxt = rows[r][t + 1] if t + 1 < len(rows[r]) else None
                for i, dst in enumerate(live[s]):
                    dst[...] = (noise.integers(0, 9, dst.shape)
                                if nxt is None else nxt[i])
    torch.cuda.synchronize()
    if back_to_back:
        outs = [{f: getattr(o, f).cpu() for f in HEADS} for o in outs]
    counts = [(sp.counters["serve.step.h2d_bytes"],
               sp.counters["serve.step.h2d_streamed_bytes"])
              for sp in profiled_stretch().named("serve.step")]
    return outs, counts


@pytest.mark.cuda
def test_back_to_back_streamed_steps_match_eager_bit_for_bit():
    """A graphed 16-slot engine steps three times back to back, its host
    rows overwritten as each step returns and no output read in between,
    against a `cuda_graph=False` engine whose outputs are read after each
    step: every step's four logit heads are equal bit for bit (the pinned
    buffers are not overwritten before their copies end, the step waits on
    its copies, the copies wait on the last step); every step's bytes all
    go up on the copy stream."""
    _require_card()
    from gridmm_tpu_torch.config import tiny_config
    from gridmm_tpu_torch.models.navigator import init_navigator
    from gridmm_tpu_torch.serve.engine import NavServingEngine

    cfg, slots = tiny_config(), 16
    model = init_navigator(cfg.model, seed=2, device="cuda")
    texts, rows = _tiny_engine_inputs(cfg, n_req=slots, steps=3, seed=7)
    graphed = NavServingEngine.create(model, cfg, slots)
    eager = NavServingEngine.create(model, cfg, slots, cuda_graph=False)
    assert any(by_row is not None for *_, by_row in graphed._fields)
    got, counts = _drive_back_to_back(graphed, texts, rows, True)
    want, counts_eager = _drive_back_to_back(eager, texts, rows, False)
    h2d = sum(t.nbytes for t in graphed._x)
    assert counts == counts_eager == [(h2d, h2d)] * 3
    for step, (a, b) in enumerate(zip(got, want)):
        for f in HEADS:
            assert torch.equal(a[f], b[f]), (step, f)
    assert graphed.replays == 3 and eager.replays == 0


@pytest.mark.cuda
def test_graphed_engine_admitting_rows_alone_matches_full_batch_admissions():
    """A 16-slot graphed engine whose admissions encode only the rows they
    admit (16, then 1, then 3) against one whose admissions encode all 16
    rows: every served step's four logit heads within 1e-5 x max|logit|,
    -inf at the same places."""
    _require_card()
    from gridmm_tpu_torch.config import tiny_config
    from gridmm_tpu_torch.models.navigator import init_navigator
    from gridmm_tpu_torch.serve.engine import NavServingEngine, serving_cfg
    from gridmm_tpu_torch.train.step import nav_device_step

    cfg, slots = tiny_config(), 16
    model = init_navigator(cfg.model, seed=2, device="cuda")
    texts, rows = _tiny_engine_inputs(cfg, n_req=slots + 4, seed=3)

    rows_alone = NavServingEngine.create(model, cfg, slots)
    # the same model behind the plain constructor: an engine without a
    # model encodes all B rows
    scfg, served = rows_alone.cfg, rows_alone.model
    assert scfg == serving_cfg(cfg)
    every_row = NavServingEngine(
        scfg, slots, lang_fn=lambda i, m: served(
            "language", {"txt_ids": i, "txt_mask": m}),
        step_fn=lambda txt, mask, carry, x: nav_device_step(
            served, scfg, txt, mask, carry, x))
    got, seen = _drive_admissions(rows_alone, texts, rows, slots)
    want, seen_all = _drive_admissions(every_row, texts, rows, slots)
    assert seen == [slots, 1, 3]
    assert seen_all == [slots] * 3
    _assert_outs_close([{f: o[f] for f in HEADS} for o in got],
                       [{f: o[f] for f in HEADS} for o in want])


@pytest.mark.cuda
@pytest.mark.parametrize("syncs", ["step", "admission"])
def test_graph_capture_failure_raises(syncs):
    """A step, or an admission's language forward, that waits on the host
    cannot be captured: the engine raises and does not run eager in its
    place; dropout on the card still draws afterwards (a failed capture
    must not leave CUDA's default generator in its capture state)."""
    _require_card()
    from gridmm_tpu_torch.config import tiny_config
    from gridmm_tpu_torch.models.navigator import init_navigator
    from gridmm_tpu_torch.serve.engine import NavServingEngine
    from gridmm_tpu_torch.train.step import nav_device_step

    cfg = tiny_config()
    model = init_navigator(cfg.model, seed=2, device="cuda")

    def step(txt, mask, carry, x):
        carry, out = nav_device_step(model, cfg, txt, mask, carry, x)
        if syncs == "step":
            out.fused_logits.sum().item()   # a host wait inside the step
        return carry, out

    def lang(ids, mask):
        txt = model("language", {"txt_ids": ids, "txt_mask": mask})
        if syncs == "admission":
            txt.sum().item()   # a host wait inside the admission
        return txt

    with pytest.raises(RuntimeError, match=f"capture of the serving {syncs}"):
        NavServingEngine(cfg, 2, lang_fn=lang, step_fn=step, device="cuda")
    kept = torch.nn.functional.dropout(torch.ones(1 << 16, device="cuda"),
                                       0.5, True)
    assert 0.45 < (kept > 0).float().mean().item() < 0.55


@pytest.mark.cuda
def test_bundle_round_trip_on_card(tmp_path):
    """A tiny bundle exported on the card, loaded and served through
    `from_bundle` (graphed) with other weights, against a `create` engine
    on those weights."""
    _require_card()
    from gridmm_tpu_torch.config import tiny_config
    from gridmm_tpu_torch.models.navigator import init_navigator
    from gridmm_tpu_torch.serve.engine import NavServingEngine
    from gridmm_tpu_torch.utils.export import (export_navigator_serving,
                                               save_serving_bundle)

    cfg = tiny_config()
    exported_from = init_navigator(cfg.model, seed=0, device="cuda")
    manifest = save_serving_bundle(
        export_navigator_serving(exported_from, cfg,
                                 exported_from.state_dict(), batch=2,
                                 device="cuda"),
        str(tmp_path), cfg=cfg, extra_manifest={"batch": 2})
    assert manifest["artifacts"]["nav_step"]["platforms"] == ["cuda"]
    model = init_navigator(cfg.model, seed=6, device="cuda")
    texts, rows = _tiny_engine_inputs(cfg, seed=1)
    served = NavServingEngine.from_bundle(str(tmp_path), cfg,
                                          dict(model.state_dict()), 2)
    live = NavServingEngine.create(model, cfg, 2)
    assert served.graph_launches == {"grid_pool_fwd": 1}
    _assert_outs_close(_drive(served, texts, rows, 2),
                       _drive(live, texts, rows, 2))


# ------------------------------------------------------------------ VLN-CE
@pytest.mark.cuda
def test_ce_waypoint_nms_on_card_is_bit_exact():
    """waypoint_nms on the card keeps the CPU's peaks bit for bit (argmax
    ties to the first flat index on both)."""
    _require_card()
    from gridmm_tpu_torch.models.waypoint import waypoint_nms

    rng = np.random.default_rng(0)
    probs = torch.softmax(torch.from_numpy(
        rng.normal(size=(8, 120 * 12)).astype(np.float32) * 3), -1).reshape(
        8, 120, 12)
    probs[0] = 0.0
    probs[0, 30, 4] = probs[0, 90, 2] = 0.5          # a tie
    got = waypoint_nms(probs.cuda(), 5, (7.0, 5.0)).cpu()
    assert torch.equal(got, waypoint_nms(probs, 5, (7.0, 5.0)))


@pytest.mark.cuda
def test_ce_tiny_rollouts_card_match_cpu():
    """The tiny CE agent (CLIP head_dim 16: the per-head kernel) on the card
    takes the CPU agent's actions through the fused step and the host
    path, and launches K1, K3 and K4."""
    _require_card()
    from gridmm_tpu_torch.ce.env import SyntheticContinuousEnv
    from gridmm_tpu_torch.ce.factory import build_ce_agent
    from gridmm_tpu_torch.ops.cuda.attention import ATTENTION_FWD
    from gridmm_tpu_torch.ops.cuda.grid_pool import GRID_POOL_FWD
    from gridmm_tpu_torch.ops.cuda.layernorm import LAYERNORM_FWD

    paths = {}
    for dev in ("cpu", "cuda"):
        _, agent = build_ce_agent(tiny=True, seed=2, device=dev)
        for fused in (True, False):
            agent.fused_rollout = fused
            env = SyntheticContinuousEnv(num_envs=2, image_size=56,
                                         depth_size=256, seed=3)
            before = [k.launches for k in (GRID_POOL_FWD, LAYERNORM_FWD,
                                           ATTENTION_FWD)]
            agent.rollout(env, max_steps=4)
            after = [k.launches for k in (GRID_POOL_FWD, LAYERNORM_FWD,
                                          ATTENTION_FWD)]
            if dev == "cuda":
                assert all(a > b for a, b in zip(after, before))
            paths[dev, fused] = [np.asarray(p) for p in env.paths]
    for fused in (True, False):
        for a, b in zip(paths["cuda", fused], paths["cpu", fused]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_ce_device_step_on_card_matches_cpu():
    """device_build_step on the card against the CPU: integer and boolean
    fields equal, floats within 1e-5."""
    _require_card()
    from gridmm_tpu_torch.ce.device_step import (device_build_step,
                                                 device_candidates)
    from gridmm_tpu_torch.ce.factory import tiny_ce_configs
    from gridmm_tpu_torch.models.waypoint import waypoint_nms

    cfg = tiny_ce_configs()[0]
    rng = np.random.default_rng(1)
    b, cap = 3, cfg.model.max_action_steps
    probs = torch.softmax(torch.from_numpy(
        rng.normal(size=(b, 1440)).astype(np.float32) * 3), -1).reshape(
        b, 120, 12)
    args = dict(
        view_cls=torch.from_numpy(rng.standard_normal((b, 12, 64)).astype(
            np.float32)),
        depth=torch.from_numpy(rng.uniform(0, 1, (b, 12, 256, 256)).astype(
            np.float32)),
        pos_xy=torch.from_numpy(rng.uniform(-4, 4, (b, 2)).astype(
            np.float32)),
        heading=torch.from_numpy(rng.uniform(-3, 3, (b,)).astype(np.float32)),
        traj_pos=torch.from_numpy(rng.normal(size=(b, cap, 3)).astype(
            np.float32)),
        traj_dist=torch.from_numpy(rng.uniform(0, 2, (b, cap)).astype(
            np.float32)),
        traj_len=torch.tensor([1, 2, 3], dtype=torch.int32),
        t=torch.tensor(2), ended=torch.tensor([False, True, False]))
    out = {}
    for dev in ("cpu", "cuda"):
        cand = device_candidates(waypoint_nms(probs.to(dev), 5), 5)
        out[dev] = device_build_step(
            cfg, cand, **{k: v.to(dev) for k, v in args.items()})
    for f, a, c in zip(out["cpu"]._fields, out["cuda"], out["cpu"]):
        a = a.cpu()
        if a.is_floating_point():
            torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-5, msg=f)
        else:
            assert torch.equal(a, c), f


def _encoder_op_inputs(name, dtype):
    """Card inputs of K2, K3 or K4 at a tower's shapes, with the dispatching
    function that reaches the kernel's op and the kernel's launcher."""
    from gridmm_tpu_torch.ops import attention as A
    from gridmm_tpu_torch.ops import layernorm as LN
    from gridmm_tpu_torch.ops.cuda.attention import (ATTENTION_FWD,
                                                     ATTENTION_QKV_FWD)
    from gridmm_tpu_torch.ops.cuda.layernorm import LAYERNORM_FWD

    gen = torch.Generator(device="cuda").manual_seed(0)

    def t(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    if name == "attention_qkv_fwd":     # clip_b32: 12 heads of 64, L = 50
        return (A.attention_qkv, (t(4, 50, 2304), 12), ATTENTION_QKV_FWD,
                torch.ops.gridmm.attention_qkv_fwd.default)
    if name == "attention_fwd":         # the tiny tower: head_dim 16
        return (A.attention, (t(16, 50, 16), t(16, 50, 16), t(16, 50, 16)),
                ATTENTION_FWD, torch.ops.gridmm.attention_fwd.default)
    return (LN.layernorm, (t(200, 768), t(768).float(), t(768).float(),
                           1e-5),
            LAYERNORM_FWD, torch.ops.gridmm.layernorm_fwd.default)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["attention_qkv_fwd", "attention_fwd",
                                  "layernorm_fwd"])
def test_encoder_kernel_ops_refuse_a_backward_and_fake_their_outputs(
        name, dtype):
    """K2, K4 and K3 run as the custom ops `gridmm::<name>` on the card: one
    launch a call; with inputs that need a gradient the output carries a
    grad_fn whose backward raises (no formula is registered) instead of
    dropping the gradient; the op's fake body gives the kernel's shape,
    dtype and device."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    _require_card()
    fn, args, launcher, op = _encoder_op_inputs(name, dtype)
    before = launcher.launches
    want = fn(*args)
    torch.cuda.synchronize()
    assert launcher.launches == before + 1
    grad_args = [a.clone().requires_grad_(True)
                 if isinstance(a, torch.Tensor) else a for a in args]
    out = fn(*grad_args)
    assert out.requires_grad and out.grad_fn is not None
    with pytest.raises(RuntimeError, match="no autograd formula"):
        out.float().sum().backward()
    assert torch.equal(out.detach(), want)
    with FakeTensorMode() as mode:
        fake = op(*[mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                    for a in args])
    assert (fake.shape, fake.dtype, fake.device) == \
        (want.shape, want.dtype, want.device)
    assert launcher.launches == before + 2


@pytest.mark.cuda
def test_tiny_tower_exports_on_the_card_with_eager_bits():
    """The --tiny preprocess tower (head_dim 16: K4, K3) goes through
    torch.export on the card and its program gives the eager tower's
    bits."""
    from gridmm_tpu_torch.models.clip_vit import (ClipVisionConfig,
                                                  init_clip_vision)
    from gridmm_tpu_torch.ops.cuda.attention import ATTENTION_FWD

    _require_card()
    cfg = ClipVisionConfig(input_resolution=56, patch_size=8, width=64,
                           layers=2, heads=4, compute_dtype="float32")
    tower = init_clip_vision(cfg, seed=0, device="cuda")
    x = torch.randn((6, 56, 56, 3), device="cuda")
    with torch.no_grad():
        eager = tower(x)
        program = torch.export.export(tower, (x,))
        before = ATTENTION_FWD.launches
        got = program.module()(x)
    torch.cuda.synchronize()
    assert ATTENTION_FWD.launches == before + cfg.layers
    assert torch.equal(got, eager)
