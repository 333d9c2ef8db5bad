"""ctypes wrapper of the grid-pool forward kernel (csrc/grid_pool_fwd.cu).

Replaces the TPU kernel `_pool_kernel`
(gridmm_tpu/ops/pallas/grid_pool_kernel.py:30). The wrapper checks its
inputs, computes the per-cell max with one scatter-max (outside the kernel,
as `_prep_inputs` does around the Pallas body), allocates the zero-filled
outputs and launches on the current stream. `GRID_POOL_FWD.launches` counts
the launches.
"""

from __future__ import annotations

import ctypes

import torch

from gridmm_tpu_torch.ops.cuda import build

CELL_PAD = 256
SOURCE = "grid_pool_fwd"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class GridPoolFwd:
    """Launcher with a launch count (one per kernel launch)."""

    name = "grid_pool_fwd"
    source = "gridmm_tpu_torch/csrc/grid_pool_fwd.cu"
    replaces = "gridmm_tpu/ops/pallas/grid_pool_kernel.py:30"

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _function(self):
        if self._fn is None:
            self._fn = build.function(SOURCE, "gridmm_grid_pool_fwd", [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        return self._fn

    def __call__(self, point_fts, cell_ids, weights, num_cells: int = 196):
        """(B,N,D) f32|bf16 features, (B,N) int32 cells, (B,N) f32 weights
        -> (numer (B, num_cells, D) f32, denom (B, 256) f32)."""
        if point_fts.device.type != "cuda":
            raise ValueError("grid_pool_fwd needs CUDA tensors, got "
                             f"{point_fts.device}")
        if point_fts.dim() != 3:
            raise ValueError(f"point_fts must be (B,N,D), got "
                             f"{tuple(point_fts.shape)}")
        b, n, d = point_fts.shape
        if point_fts.dtype not in _DTYPE_CODE:
            raise TypeError(f"point_fts dtype {point_fts.dtype} not in "
                            "(float32, bfloat16)")
        if cell_ids.dtype != torch.int32 or weights.dtype != torch.float32:
            raise TypeError("cell_ids must be int32 and weights float32, got "
                            f"{cell_ids.dtype}, {weights.dtype}")
        for name, t in (("cell_ids", cell_ids), ("weights", weights)):
            if tuple(t.shape) != (b, n):
                raise ValueError(f"{name} must be {(b, n)}, got "
                                 f"{tuple(t.shape)}")
            if t.device != point_fts.device:
                raise ValueError(f"{name} on {t.device}, features on "
                                 f"{point_fts.device}")
        if not (point_fts.is_contiguous() and cell_ids.is_contiguous()
                and weights.is_contiguous()):
            raise ValueError("grid_pool_fwd needs contiguous inputs")
        if not 1 <= num_cells <= CELL_PAD:
            raise ValueError(f"num_cells must be in [1, {CELL_PAD}]")
        if b * n >= 2 ** 31 or n * d >= 2 ** 31:
            raise ValueError("grid_pool_fwd indexes rows with 32-bit ints")

        cmax = cell_max(cell_ids, weights, num_cells)
        numer = torch.zeros((b, num_cells, d), dtype=torch.float32,
                            device=point_fts.device)
        denom = torch.zeros((b, CELL_PAD), dtype=torch.float32,
                            device=point_fts.device)
        self.launch(point_fts, cell_ids, weights, cmax, numer, denom)
        self.launches += 1
        return numer, denom

    def launch(self, point_fts, cell_ids, weights, cmax, numer, denom):
        """The bare kernel launch on checked, prepared tensors: adds into
        `numer` and `denom` (zero-filled by the caller). Not counted."""
        b, n, d = point_fts.shape
        num_cells = cmax.shape[1]
        dev = point_fts.device
        # enough N slices to give every SM two blocks
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        tiles = b * ((d + 127) // 128)
        n_slices = max(1, min(-(-n // 256), -(-2 * sms // tiles)))
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            err = self._function()(
                point_fts.data_ptr(), _DTYPE_CODE[point_fts.dtype],
                cell_ids.data_ptr(), weights.data_ptr(), cmax.data_ptr(),
                numer.data_ptr(), denom.data_ptr(), b, n, d, num_cells,
                n_slices, stream)
        if err != 0:
            raise RuntimeError(f"grid_pool_fwd launch failed: cudaError {err}")


def cell_max(cell_ids, weights, num_cells: int = 196):
    """(B, num_cells) per-cell max of the weights (-inf for empty cells) —
    the softmax stabilizer `_prep_inputs` computes outside the Pallas body."""
    b = cell_ids.shape[0]
    valid = (cell_ids >= 0) & (cell_ids < num_cells)
    seg = torch.where(valid, cell_ids,
                      torch.full_like(cell_ids, num_cells)).long()
    cmax = torch.full((b, num_cells + 1), float("-inf"),
                      device=cell_ids.device).scatter_reduce_(
        1, seg, weights.masked_fill(~valid, float("-inf")), "amax")
    return cmax[:, :num_cells].contiguous()


GRID_POOL_FWD = GridPoolFwd()


def grid_pool_fwd(point_fts, cell_ids, weights, num_cells: int = 196):
    return GRID_POOL_FWD(point_fts, cell_ids, weights, num_cells)
