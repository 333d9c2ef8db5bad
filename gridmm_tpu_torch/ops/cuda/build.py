"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and compiles on its own into
`gridmm_tpu_torch/build/lib<name>-<hash>.so` for sm_90a (Hopper), where
<hash> covers the source, the shared headers (`csrc/*.cuh`) and the flags,
so an edited source never loads a stale library. Builds happen at first use, never at import; `build_all`
starts one nvcc per source, all at once. Every function takes the source
directory, so that a timing script can load another tree's build of the same
kernel beside this one's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

PKG_DIR = Path(__file__).resolve().parents[2]
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")

_LOADED: Dict[Path, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "build only on a machine with the CUDA toolkit")
    return found


def library_path(name: str, src_dir: Path = SRC_DIR) -> Path:
    h = hashlib.sha256((src_dir / f"{name}.cu").read_bytes())
    for header in sorted(src_dir.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: Iterable[str],
              src_dir: Path = SRC_DIR) -> Dict[str, str]:
    """Compile every named source that has no current library, one nvcc
    process each, all started together. Returns {name: ptxas report}.
    Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        out = library_path(name, src_dir)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src_dir / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str, src_dir: Path = SRC_DIR) -> ctypes.CDLL:
    """The loaded library for <src_dir>/<name>.cu, building it if needed."""
    key = Path(src_dir).resolve() / name
    lib = _LOADED.get(key)
    if lib is None:
        build_all([name], src_dir)
        lib = ctypes.CDLL(str(library_path(name, src_dir)))
        _LOADED[key] = lib
    return lib


def function(name: str, symbol: str, argtypes, src_dir: Path = SRC_DIR):
    """The C function `symbol` of <src_dir>/<name>.cu with its argument
    types set; it returns a cudaError_t as an int."""
    fn = getattr(load(name, src_dir), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
