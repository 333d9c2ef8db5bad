"""Convert reference HDF5 feature artifacts to gmmstore, mmap + prefetch (twin
of gridmm_tpu/cli/convert_store.py).

  python -m gridmm_tpu_torch.cli.convert_store --input clip_p32.hdf5 \
      --output clip_p32.gmm [--dtype float16] [--slice-depth-patches]

--slice-depth-patches converts a (36,128,128) depth store into the (12,49)
patch-center records the grid build consumes (saves 99% of the bytes). h5py
is imported only when the CLI runs."""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--dtype", default=None,
                   help="cast records (e.g. float16, uint16)")
    p.add_argument("--slice-depth-patches", action="store_true")
    args = p.parse_args(argv)

    import h5py

    from gridmm_tpu_torch.data.store import write_store_streaming
    from gridmm_tpu_torch.env.world import DEPTH_PATCH_CENTERS, HORIZON_VIEWS

    with h5py.File(args.input, "r") as f:
        keys = list(f.keys())

        def transform(arr):
            if args.slice_depth_patches:
                arr = arr[:, DEPTH_PATCH_CENTERS][:, :, DEPTH_PATCH_CENTERS]
                arr = arr[HORIZON_VIEWS: 2 * HORIZON_VIEWS].reshape(12, 49)
            if args.dtype:
                arr = arr.astype(np.dtype(args.dtype))
            return arr

        first = transform(f[keys[0]][...])
        # streaming: one record in RAM at a time (real stores are tens of GB)
        write_store_streaming(
            args.output, keys, lambda k: transform(f[k][...]),
            first.shape, first.dtype)
    print(f"wrote {len(keys)} records -> {args.output}")


if __name__ == "__main__":
    main()
