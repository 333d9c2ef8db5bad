"""Port vs JAX package: ops/grid_pool.py on the CPU.

The port's plain pool (the CUDA kernel's oracle) is held against both JAX
formulations — the XLA `grid_scatter_pool` and the Pallas kernel
`pallas_grid_pool_raw` in interpret mode — at 1e-5 absolute and relative;
the cell mask must match exactly. The cases include rows longer than the
CUDA forward once took (N = 40,000) and a row with 90% of its points in one
cell, for the pool and its VJP."""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import gridmm_tpu.ops.grid_pool as JP  # noqa: E402
import gridmm_tpu_torch.ops.grid_pool as TP  # noqa: E402
from gridmm_tpu.ops.pallas.grid_pool_kernel import (  # noqa: E402
    _prep_inputs, pallas_grid_pool_bwd, pallas_grid_pool_raw)
from gridmm_tpu_torch.ops.cuda import grid_pool as CG  # noqa: E402
from gridmm_tpu_torch.ops.cuda.grid_pool import GRID_POOL_FWD  # noqa: E402
from torch_parity import assert_close, to_torch  # noqa: E402


def pool_case(b=3, n=1024, d=128, seed=0):
    """Random cells with ~5% invalid; row 1 all-invalid; cell 7 of row 2
    holds one point; cells 0..49 of row 0 are empty."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((b, n, d)).astype(np.float32)
    cells = rng.integers(0, 196, size=(b, n)).astype(np.int32)
    cells[rng.random((b, n)) < 0.05] = -1
    w = (rng.standard_normal((b, n)) * 3.0).astype(np.float32)
    cells[1] = -1
    cells[2][cells[2] == 7] = 8
    cells[2, 100] = 7
    cells[0][(cells[0] >= 0) & (cells[0] < 50)] = 60
    return g, cells, w


def residual_case(kind, b=3, n=1024, d=64, seed=5):
    """pool_case plus the shapes the CUDA forward's owners must get right:
    "edges" as pool_case (an empty cell range, a one-point cell, an
    all-invalid row); "all_invalid" every row invalid; "skew" cell 17 holds
    90% of row 0; "long" two rows of 40,000 points at D = 16, longer than
    one block of the CUDA forward lists."""
    if kind == "long":
        return long_case()
    g, cells, w = pool_case(b, n, d, seed)
    rng = np.random.default_rng(seed + 1)
    if kind == "all_invalid":
        cells[:] = -1
    if kind == "skew":
        cells[0][rng.random(n) < 0.9] = 17
    return g, cells, w


def long_case(b=2, n=40000, d=16, seed=11):
    """Random cells with ~5% invalid over rows of n points."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((b, n, d)).astype(np.float32)
    cells = rng.integers(0, 196, size=(b, n)).astype(np.int32)
    cells[rng.random((b, n)) < 0.05] = -1
    w = (rng.standard_normal((b, n)) * 3.0).astype(np.float32)
    return g, cells, w


def skew_case(b=2, n=8832, d=16, seed=12):
    """A serving-length buffer whose row 0 holds 90% of its points in cell
    17."""
    g, cells, w = long_case(b, n, d, seed)
    cells[0][np.random.default_rng(seed + 1).random(n) < 0.9] = 17
    return g, cells, w


def pallas_raw(g, cells, w):
    """The Pallas forward in interpret mode, chunked and padded as the JAX
    package's custom VJP does it (ops/grid_pool._chunk_and_pad)."""
    f, c, ww, chunk = JP._chunk_and_pad(jnp.asarray(g), jnp.asarray(cells),
                                        jnp.asarray(w))
    return pallas_grid_pool_raw(f, c, ww, chunk=chunk, interpret=True)


@pytest.mark.parametrize("kind", ["edges", "all_invalid", "skew"])
def test_plain_cell_max_and_denominator_match_jax_residuals(kind):
    """The residuals the CUDA forward hands to the backward, as the plain
    version computes them, against the JAX package's: the cell max of
    `_prep_inputs` (which writes 0 where the port keeps -inf, for an empty
    cell) and the denominator of the Pallas kernel in interpret mode; f32
    within 1e-5."""
    g, cells, w = residual_case(kind)
    tg, tc, tw = to_torch((g, cells, w))
    cmax = TP.cell_max(tc, tw)
    pooled, mask, denom = TP.grid_scatter_pool_raw(tg, tc, tw)
    _, _, jmax, _ = _prep_inputs(jnp.asarray(g), jnp.asarray(cells),
                                 jnp.asarray(w), 196, 256)
    jmax = np.asarray(jmax)[:, 0, :196]
    k_p, k_m, k_d = pallas_grid_pool_raw(jnp.asarray(g), jnp.asarray(cells),
                                         jnp.asarray(w), chunk=256,
                                         interpret=True)
    assert cmax.shape == (3, 196) and cmax.dtype == torch.float32
    filled = mask.numpy()
    np.testing.assert_array_equal(filled, np.asarray(k_m))
    assert torch.isinf(cmax[~mask]).all() and (cmax[~mask] < 0).all()
    assert (jmax[~filled] == 0).all()
    assert_close(cmax[mask], jmax[filled], rtol=1e-5, atol=1e-5)
    assert_close(denom, k_d, rtol=1e-5, atol=1e-5)
    assert (denom[:, :196][~mask] == 0).all() and (denom[:, 196:] == 0).all()
    assert_close(pooled, k_p, rtol=1e-5, atol=1e-5)
    if kind == "all_invalid":
        assert not mask.any() and (pooled == 0).all()
    if kind == "skew":
        assert int((tc[0] == 17).sum()) > 0.85 * tc.shape[1] and mask[0, 17]


@pytest.mark.parametrize("kind", ["edges", "skew", "long"])
def test_pool_function_on_cpu_returns_three_outputs_with_jax_vjp(kind):
    """`GridPoolFunction` on the CPU: (pooled, cell_mask, denom) from the
    plain version, and gradients of the features and the weights equal to
    the JAX package's VJP of `grid_scatter_pool` and to its Pallas backward
    in interpret mode (chunked as its custom VJP chunks), within 1e-5 of
    their max."""
    g, cells, w = residual_case(kind)
    b, n, d = g.shape
    rng = np.random.default_rng(9)
    cot = rng.standard_normal((b, 196, d)).astype(np.float32)
    tg = torch.from_numpy(g).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    out = TP.GridPoolFunction.apply(tg, torch.from_numpy(cells), tw, 196)
    assert len(out) == 3
    pooled, mask, denom = out
    want = TP.grid_scatter_pool_raw(tg.detach(), torch.from_numpy(cells),
                                    tw.detach())
    for a, b_ in zip(out, want):
        assert torch.equal(a.detach(), b_)
    assert pooled.requires_grad and not mask.requires_grad \
        and not denom.requires_grad
    pooled.backward(torch.from_numpy(cot))
    _, vjp = jax.vjp(
        lambda f, x: JP.grid_scatter_pool(f, jnp.asarray(cells), x)[0],
        jnp.asarray(g), jnp.asarray(w))
    jg, jw = vjp(jnp.asarray(cot))
    f, c, ww, chunk = JP._chunk_and_pad_cap(
        jnp.asarray(g), jnp.asarray(cells), jnp.asarray(w), 1024)
    _, _, k_denom = pallas_grid_pool_raw(f, c, ww, chunk=chunk,
                                         interpret=True)
    k_dg, k_dw = pallas_grid_pool_bwd(f, c, ww, k_denom, jnp.asarray(cot),
                                      chunk=chunk, interpret=True)
    for got, ref in ((tg.grad, jg), (tw.grad, jw),
                     (tg.grad, k_dg[:, :n]), (tw.grad, k_dw[:, :n])):
        ref = np.asarray(ref)
        tol = 1e-5 * max(float(np.abs(ref).max()), 1.0)
        assert_close(got, ref, rtol=0, atol=tol)


@pytest.mark.parametrize("case", ["edges", "long", "skew"])
def test_plain_pool_matches_xla_and_pallas_interpret(case):
    """"edges": pool_case (an all-invalid row, a one-point cell, empty
    cells), the Pallas kernel in chunks of 256; "long": two rows of 40,000
    points; "skew": a serving-length row with 90% of its points in one
    cell; these two with the Pallas kernel chunked and padded as the JAX
    package runs it."""
    g, cells, w = {"edges": pool_case, "long": long_case,
                   "skew": skew_case}[case]()
    b = g.shape[0]
    got_p, got_m, got_d = TP.grid_scatter_pool_raw(*to_torch((g, cells, w)))
    want_p, want_m = JP.grid_scatter_pool(jnp.asarray(g), jnp.asarray(cells),
                                          jnp.asarray(w))
    if case == "edges":
        k_p, k_m, k_d = pallas_grid_pool_raw(
            jnp.asarray(g), jnp.asarray(cells), jnp.asarray(w), chunk=256,
            interpret=True)
    else:
        k_p, k_m, k_d = pallas_raw(g, cells, w)
    for want in (want_m, k_m):
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(want))
    assert_close(got_p, want_p)
    assert_close(got_p, k_p)
    assert_close(got_d, k_d)
    assert got_d.shape == (b, 256) and got_p.dtype == torch.float32
    if case == "edges":
        assert not got_m[1].any() and (got_p[1] == 0).all()
        assert got_m[2, 7] and not got_m[0, :50].any()
        assert_close(got_p[2, 7], g[2, 100], rtol=1e-6, atol=1e-6)
    if case == "skew":
        assert int((cells[0] == 17).sum()) > 0.85 * cells.shape[1]


@pytest.mark.parametrize("b,n", [(1, 1), (4, 8832), (16, 8832), (16, 8820),
                                 (8, 12416), (4, 11776), (2, 40000),
                                 (1, 300000),
                                 (65537, 4), (3, 10 ** 6)])
def test_cuda_launch_shapes_cover_any_row(b, n):
    """The CUDA wrappers' launch shapes, pure arithmetic: the forward deals
    a row to 1-8 blocks of a cluster in runs of 32 points (one block for
    each SPLIT_POINTS points: the serving and pipeline buffers' 8,832 go to
    one, the pretraining and CE buffers' to two, so that a cell holding
    much of a long row is streamed by several SMs); a block lists at most
    MAX_CHUNK points of its share at a time, within the 16-bit indices;
    the backward's pass 1 cuts a row into 1 to N tiles. No shape is
    refused for its N or B."""
    group, row_split, chunk = CG.fwd_launch_shape(b, n, 196)
    assert 1 <= group <= CG.MAX_GROUP
    assert 1 <= row_split <= CG.MAX_ROW_SPLIT
    assert 1 <= chunk <= min(CG.MAX_CHUNK, 65536)
    # the blocks' shares of 32-point runs cover the row; a share that fits
    # is listed in one chunk
    share = -(-n // 32 // row_split) * 32 if row_split > 1 else n
    assert row_split * share >= n
    assert chunk == min(share, CG.MAX_CHUNK)
    assert row_split == min(CG.MAX_ROW_SPLIT, -(-n // CG.SPLIT_POINTS))
    assert row_split == {8832: 1, 8820: 1, 12416: 2, 11776: 2}.get(
        n, row_split)
    assert row_split >= min(CG.MAX_ROW_SPLIT, -(-n // CG.MAX_CHUNK))
    for sms in (1, 132):
        tiles = CG.bwd_tiles(b, n, sms)
        assert 1 <= tiles <= n and b * tiles < 2 ** 31


def test_bf16_features_pool_in_f32():
    """A bf16 buffer pools its own (rounded) values, accumulated in f32."""
    g, cells, w = pool_case(seed=1)
    gb = torch.from_numpy(g).to(torch.bfloat16)
    got_p, got_m = TP.grid_scatter_pool(gb, *to_torch((cells, w)))
    want_p, want_m = JP.grid_scatter_pool(
        jnp.asarray(gb.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(cells), jnp.asarray(w))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    assert_close(got_p, want_p)


def test_cpu_dispatch_runs_plain_version():
    g, cells, w = pool_case(seed=2)
    before = GRID_POOL_FWD.launches
    got = TP.grid_pool(*to_torch((g, cells, w)))
    want = TP.grid_scatter_pool(*to_torch((g, cells, w)))
    assert GRID_POOL_FWD.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        GRID_POOL_FWD(*to_torch((g, cells, w)))


@pytest.mark.parametrize("masked", [False, True])
def test_relevance_and_weighted_grid(masked):
    rng = np.random.default_rng(3)
    b, n, t, d = 2, 300, 12, 64
    f = rng.standard_normal((b, n, d)).astype(np.float32)
    txt = rng.standard_normal((b, t, d)).astype(np.float32)
    tmask = np.arange(t)[None] < np.array([[7], [12]])
    wt, bt, wg, bg = (rng.standard_normal(s).astype(np.float32) * 0.1
                      for s in ((d, d), (d,), (d, d), (d,)))
    cells = rng.integers(-1, 196, size=(b, n)).astype(np.int32)
    mask = tmask if masked else None
    assert_close(TP.instruction_relevance(*to_torch((f, txt, mask))),
                 JP.instruction_relevance(jnp.asarray(f), jnp.asarray(txt),
                                          None if mask is None
                                          else jnp.asarray(mask)))
    got = TP.relevance_weighted_grid(*to_torch((f, cells, txt, wt, bt, wg,
                                                bg, mask)))
    want = JP.relevance_weighted_grid(
        *map(jnp.asarray, (f, cells, txt, wt, bt, wg, bg)),
        txt_mask=None if mask is None else jnp.asarray(mask))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert_close(got[0], want[0])
