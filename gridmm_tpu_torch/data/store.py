"""gmmstore: fixed-shape keyed array store, writer and readers (a copy of
the JAX-free gridmm_tpu/data/store.py, so the port needs nothing of the JAX
package).

The write side is Python; the hot read path is the C++ mmap/prefetch library
(native/feature_store.cc) through ctypes, with a pure-Python mmap reader of
the same format where the library cannot be built. Replaces the reference's
HDF5 stores and in-RAM caches (utils/data.py:10-76, r2r/env.py:80-113).

The library is compiled from native/feature_store.cc, which stays read-only,
with g++ into the git-ignored gridmm_tpu_torch/build/, under a name that
carries a hash of the source and flags. It is written under a temporary name
and renamed into place, so two processes that build it at once never load a
half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import mmap
import os
import shutil
import struct
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

MAGIC = b"GMMSTOR1"
KEY_LEN = 64
DTYPES = {0: np.float32, 1: np.float16, 2: np.uint16, 3: np.int32, 4: np.uint8}
DTYPE_CODES = {np.dtype(v): k for k, v in DTYPES.items()}

_REPO = Path(__file__).resolve().parents[2]
NATIVE_SRC = _REPO / "native" / "feature_store.cc"
BUILD_DIR = _REPO / "gridmm_tpu_torch" / "build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")


def _write_header(f, code: int, shape, keys, rec_bytes: int) -> None:
    f.write(MAGIC)
    f.write(struct.pack("<II", code, len(shape)))
    f.write(struct.pack(f"<{len(shape)}Q", *shape))
    f.write(struct.pack("<Q", len(keys)))
    for i, k in enumerate(keys):
        f.write(k.encode().ljust(KEY_LEN, b"\0"))
        f.write(struct.pack("<Q", i * rec_bytes))
    f.write(b"\0" * ((-f.tell()) % 64))


def _check_key(k: str) -> None:
    if len(k.encode()) >= KEY_LEN:
        raise ValueError(f"key too long: {k}")


def write_store_streaming(path: str, keys: Sequence[str], fetch,
                          shape, dtype) -> None:
    """Two-pass streaming writer: keys are known up front, records are
    fetched one at a time via `fetch(key) -> np.ndarray`, so RAM stays at
    one record whatever the store's size."""
    dtype = np.dtype(dtype)
    code = DTYPE_CODES[dtype]
    keys = sorted(keys)
    for k in keys:
        _check_key(k)
    with open(path, "wb") as f:
        _write_header(f, code, shape, keys,
                      int(np.prod(shape)) * dtype.itemsize)
        for k in keys:
            arr = np.ascontiguousarray(fetch(k))
            if arr.shape != tuple(shape) or arr.dtype != dtype:
                raise ValueError(f"record {k}: shape/dtype mismatch")
            f.write(arr.tobytes())


def write_store(path: str, records: Dict[str, np.ndarray]) -> None:
    """Write records (all of one dtype and shape) to a gmmstore file."""
    items = sorted(records.items())
    first = items[0][1]
    dtype = np.dtype(first.dtype)
    dims = first.shape
    for k, v in items:
        if v.shape != dims or v.dtype != dtype:
            raise ValueError(f"record {k}: shape/dtype mismatch")
        _check_key(k)
    with open(path, "wb") as f:
        _write_header(f, DTYPE_CODES[dtype], dims, [k for k, _ in items],
                      int(np.prod(dims)) * dtype.itemsize)
        for _, v in items:
            f.write(np.ascontiguousarray(v).tobytes())


def native_library_path() -> Path:
    h = hashlib.sha256(NATIVE_SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libgmmstore-{h.hexdigest()[:16]}.so"


def _build_native() -> Optional[Path]:
    """The library's path, compiling it first if needed; None where there
    is no C++ compiler. Raises with the compiler's output if it fails."""
    out = native_library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(NATIVE_SRC)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {NATIVE_SRC.name} failed:\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


_LIB: list = []


def _native_lib() -> Optional[ctypes.CDLL]:
    if _LIB:
        return _LIB[0]
    so = _build_native()
    if so is None:
        return None
    lib = ctypes.CDLL(str(so))
    lib.gmm_store_open.restype = ctypes.c_void_p
    lib.gmm_store_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.gmm_store_close.argtypes = [ctypes.c_void_p]
    lib.gmm_store_count.restype = ctypes.c_uint64
    lib.gmm_store_count.argtypes = [ctypes.c_void_p]
    lib.gmm_store_rank.restype = ctypes.c_uint32
    lib.gmm_store_rank.argtypes = [ctypes.c_void_p]
    lib.gmm_store_dims.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_uint64)]
    lib.gmm_store_dtype.restype = ctypes.c_uint32
    lib.gmm_store_dtype.argtypes = [ctypes.c_void_p]
    lib.gmm_store_record_bytes.restype = ctypes.c_uint64
    lib.gmm_store_record_bytes.argtypes = [ctypes.c_void_p]
    lib.gmm_store_get.restype = ctypes.c_void_p
    lib.gmm_store_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.gmm_store_prefetch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int]
    _LIB.append(lib)
    return lib


class NativeStoreReader:
    """Zero-copy reads through the C++ mmap library, with async prefetch."""

    def __init__(self, path: str, prefetch_threads: int = 2):
        self._h = None
        self._lib = _native_lib()
        if self._lib is None:
            raise RuntimeError("libgmmstore unavailable (no C++ compiler)")
        self._h = self._lib.gmm_store_open(path.encode(), prefetch_threads)
        if not self._h:
            raise OSError(f"cannot open gmmstore {path}")
        rank = self._lib.gmm_store_rank(self._h)
        dims = (ctypes.c_uint64 * rank)()
        self._lib.gmm_store_dims(self._h, dims)
        self.shape = tuple(int(d) for d in dims)
        self.dtype = np.dtype(DTYPES[self._lib.gmm_store_dtype(self._h)])
        self._nbytes = int(self._lib.gmm_store_record_bytes(self._h))
        self._buf_t = ctypes.c_uint8 * self._nbytes  # cached ctypes type

    def __len__(self):
        return int(self._lib.gmm_store_count(self._h))

    def get(self, key: str, copy: bool = True) -> np.ndarray:
        ptr = self._lib.gmm_store_get(self._h, key.encode())
        if not ptr:
            raise KeyError(key)
        view = np.frombuffer(self._buf_t.from_address(ptr),
                             dtype=self.dtype).reshape(self.shape)
        # copy=False returns a zero-copy view into the mapping, valid only
        # while the store is open
        return view.copy() if copy else view

    def prefetch(self, keys: Sequence[str]) -> None:
        arr = (ctypes.c_char_p * len(keys))(*[k.encode() for k in keys])
        self._lib.gmm_store_prefetch(self._h, arr, len(keys))

    def close(self):
        if self._h:
            self._lib.gmm_store_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


class PyStoreReader:
    """Pure-Python mmap reader of the same format."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        mm = self._mm
        if mm[:8] != MAGIC:
            raise ValueError(f"{path}: bad magic")
        code, rank = struct.unpack("<II", mm[8:16])
        off = 16
        self.shape = struct.unpack(f"<{rank}Q", mm[off:off + 8 * rank])
        off += 8 * rank
        (count,) = struct.unpack("<Q", mm[off:off + 8])
        off += 8
        self.dtype = np.dtype(DTYPES[code])
        self._nbytes = int(np.prod(self.shape)) * self.dtype.itemsize
        self._index = {}
        for _ in range(count):
            key = mm[off:off + KEY_LEN].rstrip(b"\0").decode()
            (data_off,) = struct.unpack(
                "<Q", mm[off + KEY_LEN:off + KEY_LEN + 8])
            self._index[key] = data_off
            off += KEY_LEN + 8
        self._blob = (off + 63) & ~63

    def __len__(self):
        return len(self._index)

    def keys(self):
        return list(self._index)

    def get(self, key: str) -> np.ndarray:
        off = self._blob + self._index[key]
        return np.frombuffer(
            self._mm[off:off + self._nbytes], dtype=self.dtype
        ).reshape(self.shape)

    def prefetch(self, keys):
        pass

    def close(self):
        self._mm.close()
        self._f.close()


def open_store(path: str, prefer_native: bool = True):
    """The native reader where the library builds, else the Python one."""
    if prefer_native:
        try:
            return NativeStoreReader(path)
        except RuntimeError:
            pass
    return PyStoreReader(path)
