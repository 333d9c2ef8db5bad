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
