"""Bytes the grid pool's kernels must move, each input byte read once and
each output byte written once (K1: csrc/grid_pool_fwd.cu; K5a:
csrc/grid_pool_bwd.cu pass 1)."""

CELLS, CELL_PAD = 196, 256


def fwd_bytes(b: int, n: int, d: int, valid: int, elem: int) -> int:
    """K1 over (b, n, d) features of `elem` bytes with `valid` points in a
    cell: those points' features, every cell id and weight (4 + 4 bytes a
    point), and the outputs (pooled f32, mask, denominator padded to 256,
    cell max)."""
    return (valid * d * elem + b * n * 8 + b * CELLS * d * 4 + b * CELLS
            + b * CELL_PAD * 4 + b * CELLS * 4)


def bwd1_bytes(b: int, n: int, d: int, valid: int, elem: int) -> int:
    """K5a: the valid points' features, every feature gradient row written,
    the (b, 196, d) f32 cotangent, ids, weights and s (12 bytes a point),
    and the per-cell residuals (cell max, denominator, S)."""
    return (valid * d * elem + b * n * d * elem + b * CELLS * d * 4
            + b * n * 12 + b * (CELLS + 2 * CELL_PAD) * 4)
