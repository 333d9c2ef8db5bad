"""ctypes wrappers of the grid-pool kernels (csrc/grid_pool_fwd.cu and
csrc/grid_pool_bwd.cu).

`GRID_POOL_FWD` replaces the TPU kernel `_pool_kernel`
(gridmm_tpu/ops/pallas/grid_pool_kernel.py:30) and what surrounds it there:
one launch writes the pooled cells, the cell mask, the denominator and the
per-cell max, none of which needs initialising. The wrapper checks its
inputs, allocates the four outputs and launches on the current stream.
`GRID_POOL_BWD1` and `GRID_POOL_BWD2` replace `_pool_bwd1_kernel` (:164) and
`_pool_bwd2_kernel` (:198), the two passes of the pool's backward. Each
launcher's `launches` counts its kernel launches.

The kernels take any (B, N, D) that fits the card's memory, as the JAX pool
does, and give the same bits on every run: the forward deals a long row to
a thread-block cluster and lists a long share in chunks
(`fwd_launch_shape`); pass 1 sums S from per-tile partials in tile order
(`bwd_tiles`). The wrapper picks the launch shapes from the
inputs' shape.
"""

from __future__ import annotations

import ctypes

import torch

from gridmm_tpu_torch.ops.cuda import build

CELL_PAD = 256
SOURCE = "grid_pool_fwd"
SOURCE_BWD = "grid_pool_bwd"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUP = 4            # cells a block may own
# the forward deals a row longer than SPLIT_POINTS to a cluster of
# ceil(N / SPLIT_POINTS) blocks (at most MAX_ROW_SPLIT, a portable cluster)
# in runs of 32 points, so that a cell holding much of a long row is
# streamed by several SMs; such a block owns MAX_GROUP cells. Timed on the
# main paths' own buffers (PERF.md section 6), splitting the serving and
# pipeline buffers' 8,832 points costs more than it saves, and splitting the
# pretraining and CE buffers' 12,416 and 11,776 saves. An unsplit row goes
# to blocks of up to MAX_GROUP cells, about TARGET_BLOCKS of them. A block
# lists at most MAX_CHUNK points of its share at a time (16-bit indices and
# a weight: 96 KB of shared memory), all of it at the main paths' shapes.
MAX_ROW_SPLIT = 8
SPLIT_POINTS = 8832
MAX_CHUNK = 16384
TARGET_BLOCKS = 1024
# the backward's pass 1 cuts each row into tiles, about TILE_BLOCKS_PER_SM
# blocks of 8 warps an SM over the batch (four waves), and at least 32
# points a tile
TILE_BLOCKS_PER_SM = 32


def fwd_launch_shape(b: int, n: int, num_cells: int):
    """(group, row_split, chunk) of the forward's launch for B rows of N
    points: cells a block owns, blocks (one cluster) that share a row, and
    the points of its share a block lists at a time. Any N and B."""
    row_split = max(1, min(MAX_ROW_SPLIT, -(-n // SPLIT_POINTS)))
    if row_split > 1:
        group = MAX_GROUP
    else:
        group = max(1, min(MAX_GROUP, -(-b * num_cells // TARGET_BLOCKS)))
    share = -(-n // 32 // row_split) * 32 if row_split > 1 else n
    return group, row_split, min(MAX_CHUNK, share)


def bwd_tiles(b: int, n: int, sms: int) -> int:
    """Tiles of a row in the backward's pass 1 (1 to N)."""
    return max(1, min(-(-sms * TILE_BLOCKS_PER_SM // b), n // 32))


class GridPoolFwd:
    """Launcher with a launch count (one per kernel launch)."""

    name = "grid_pool_fwd"
    source = "gridmm_tpu_torch/csrc/grid_pool_fwd.cu"
    replaces = "gridmm_tpu/ops/pallas/grid_pool_kernel.py:30"
    symbol = "gridmm_grid_pool_fwd"
    # g, dtype, cells, w, pooled, mask, denom, cmax, b, n, d, num_cells,
    # group, row_split, chunk, stream
    argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
                + [ctypes.c_int] * 7 + [ctypes.c_void_p])

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _function(self):
        if self._fn is None:
            self._fn = build.function(SOURCE, self.symbol, self.argtypes)
        return self._fn

    def __call__(self, point_fts, cell_ids, weights, num_cells: int = 196):
        """(B,N,D) f32|bf16 features, (B,N) int32 cells, (B,N) f32 weights
        -> (pooled (B, num_cells, D) f32, cell_mask (B, num_cells) bool,
        denom (B, 256) f32, cmax (B, num_cells) f32, -inf for empty cells).
        The same inputs give the same bits on every run."""
        b, n, d = _check_points(self.name, point_fts, cell_ids, weights,
                                num_cells)
        dev = point_fts.device
        pooled = torch.empty((b, num_cells, d), dtype=torch.float32,
                             device=dev)
        cell_mask = torch.empty((b, num_cells), dtype=torch.bool, device=dev)
        denom = torch.empty((b, CELL_PAD), dtype=torch.float32, device=dev)
        cmax = torch.empty((b, num_cells), dtype=torch.float32, device=dev)
        self.launch(point_fts, cell_ids, weights, pooled, cell_mask, denom,
                    cmax)
        self.launches += 1
        return pooled, cell_mask, denom, cmax

    def launch(self, point_fts, cell_ids, weights, pooled, cell_mask, denom,
               cmax, shape=None):
        """The bare kernel launch on checked tensors: writes all four
        outputs in full. `shape` is (group, row_split, chunk), by default
        `fwd_launch_shape`'s. Not counted."""
        b, n, d = point_fts.shape
        num_cells = cmax.shape[1]
        dev = point_fts.device
        group, row_split, chunk = shape or fwd_launch_shape(b, n,
                                                            num_cells)
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            err = self._function()(
                point_fts.data_ptr(), _DTYPE_CODE[point_fts.dtype],
                cell_ids.data_ptr(), weights.data_ptr(), pooled.data_ptr(),
                cell_mask.data_ptr(), denom.data_ptr(), cmax.data_ptr(),
                b, n, d, num_cells, group, row_split, chunk, stream)
        if err != 0:
            raise RuntimeError(f"grid_pool_fwd launch failed: cudaError {err}")


def _check_points(name, point_fts, cell_ids, weights, num_cells):
    """The checks every pool kernel shares; returns (B, N, D)."""
    if point_fts.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {point_fts.device}")
    if point_fts.dim() != 3:
        raise ValueError(f"point_fts must be (B,N,D), got "
                         f"{tuple(point_fts.shape)}")
    b, n, d = point_fts.shape
    if min(b, n, d) < 1:
        raise ValueError(f"{name} needs a non-empty (B,N,D), got {(b, n, d)}")
    if point_fts.dtype not in _DTYPE_CODE:
        raise TypeError(f"point_fts dtype {point_fts.dtype} not in "
                        "(float32, bfloat16)")
    if cell_ids.dtype != torch.int32 or weights.dtype != torch.float32:
        raise TypeError("cell_ids must be int32 and weights float32, got "
                        f"{cell_ids.dtype}, {weights.dtype}")
    for label, t in (("cell_ids", cell_ids), ("weights", weights)):
        if tuple(t.shape) != (b, n):
            raise ValueError(f"{label} must be {(b, n)}, got "
                             f"{tuple(t.shape)}")
        if t.device != point_fts.device:
            raise ValueError(f"{label} on {t.device}, features on "
                             f"{point_fts.device}")
    if not (point_fts.is_contiguous() and cell_ids.is_contiguous()
            and weights.is_contiguous()):
        raise ValueError(f"{name} needs contiguous inputs")
    if point_fts.data_ptr() % 16:
        raise ValueError(f"{name} needs 16-byte aligned features")
    if not 1 <= num_cells <= CELL_PAD:
        raise ValueError(f"num_cells must be in [1, {CELL_PAD}]")
    return b, n, d


def _check_f32(name, device, **tensors):
    """Each keyword is (tensor, shape): contiguous f32 on `device`."""
    for label, (t, shape) in tensors.items():
        if (t.dtype != torch.float32 or tuple(t.shape) != tuple(shape)
                or t.device != device or not t.is_contiguous()):
            raise ValueError(
                f"{name}: {label} must be contiguous float32 {tuple(shape)} "
                f"on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


class GridPoolBwd:
    """One pass of the pool's backward, with its own launch count. The two
    passes share csrc/grid_pool_bwd.cu and are driven by `grid_pool_bwd`."""

    source = "gridmm_tpu_torch/csrc/grid_pool_bwd.cu"

    def __init__(self, name, replaces, symbol, argtypes):
        self.name = name
        self.replaces = replaces
        self.launches = 0
        self.symbol = symbol
        self.argtypes = argtypes
        self._fn = None

    def launch(self, device, *args):
        """The bare launch on checked tensors; raises on a refused launch."""
        if self._fn is None:
            self._fn = build.function(SOURCE_BWD, self.symbol,
                                      self.argtypes)
        stream = torch.cuda.current_stream(device).cuda_stream
        with torch.cuda.device(device):
            err = self._fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: cudaError {err}")
        self.launches += 1


_P, _I = ctypes.c_void_p, ctypes.c_int
GRID_POOL_BWD1 = GridPoolBwd(
    "grid_pool_bwd1", "gridmm_tpu/ops/pallas/grid_pool_kernel.py:164",
    "gridmm_grid_pool_bwd1",
    [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
     _P])
GRID_POOL_BWD2 = GridPoolBwd(
    "grid_pool_bwd2", "gridmm_tpu/ops/pallas/grid_pool_kernel.py:198",
    "gridmm_grid_pool_bwd2", [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P])


def grid_pool_bwd(point_fts, cell_ids, weights, cmax, denom, cot):
    """Both passes of the pool's backward on the card.

    (B,N,D) f32|bf16 features, (B,N) int32 cells, (B,N) f32 weights, the
    forward's (B, num_cells) cell max and (B, 256) denominator, and the
    (B, num_cells, D) f32 cotangent of the pooled cells ->
    (d_fts (B,N,D) in the features' dtype, d_weights (B,N) f32,
     s (B,N) f32, S (B,256) f32); s and S are the passes' intermediates.
    """
    if cot.dim() != 3:
        raise ValueError(f"cot must be (B,C,D), got {tuple(cot.shape)}")
    num_cells = cot.shape[1]
    b, n, d = _check_points("grid_pool_bwd", point_fts, cell_ids, weights,
                            num_cells)
    dev = point_fts.device
    _check_f32("grid_pool_bwd", dev, cmax=(cmax, (b, num_cells)),
               denom=(denom, (b, CELL_PAD)), cot=(cot, (b, num_cells, d)))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tiles = bwd_tiles(b, n, sms)
    d_fts = torch.empty_like(point_fts)
    s = torch.empty((b, n), dtype=torch.float32, device=dev)
    big_s = torch.empty((b, CELL_PAD), dtype=torch.float32, device=dev)
    d_w = torch.empty((b, n), dtype=torch.float32, device=dev)
    # pass 1's scratch: one (256) partial of S a tile, and a count a row of
    # the tiles done (zero-filled: the last one sums the partials)
    partial = torch.empty((b * tiles, CELL_PAD), dtype=torch.float32,
                          device=dev)
    done = torch.zeros((b,), dtype=torch.int32, device=dev)
    GRID_POOL_BWD1.launch(
        dev, point_fts.data_ptr(), _DTYPE_CODE[point_fts.dtype],
        cell_ids.data_ptr(), weights.data_ptr(), cmax.data_ptr(),
        denom.data_ptr(), cot.data_ptr(), d_fts.data_ptr(), s.data_ptr(),
        big_s.data_ptr(), partial.data_ptr(), done.data_ptr(), b, n, d,
        num_cells, tiles)
    GRID_POOL_BWD2.launch(
        dev, cell_ids.data_ptr(), weights.data_ptr(), cmax.data_ptr(),
        denom.data_ptr(), big_s.data_ptr(), s.data_ptr(), d_w.data_ptr(),
        b, n, num_cells)
    return d_fts, d_w, s, big_s


GRID_POOL_FWD = GridPoolFwd()


def grid_pool_fwd(point_fts, cell_ids, weights, num_cells: int = 196):
    return GRID_POOL_FWD(point_fts, cell_ids, weights, num_cells)
