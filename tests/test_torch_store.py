"""Port vs JAX package: the gmmstore format (data/store.py).

A store written by either package is the same file, byte for byte, and
reads back in the other; the port's native (C++ mmap) and Python readers
agree on every key and dtype code; the streaming writer writes what the
one-shot writer writes; bad records raise. The port builds the native
library into gridmm_tpu_torch/build/, never into native/."""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import gridmm_tpu.data.store as JS  # noqa: E402
import gridmm_tpu_torch.data.store as TS  # noqa: E402

DTYPE_CODES = sorted(TS.DTYPES)


def records_of(code, n=7, shape=(12, 49), seed=0):
    rng = np.random.default_rng(seed + code)
    dtype = np.dtype(TS.DTYPES[code])
    keys = [f"scan{i // 3:02d}_vp{i:03d}" for i in range(n)]
    if dtype.kind == "f":
        arrs = [rng.standard_normal(shape).astype(dtype) for _ in keys]
    else:
        arrs = [rng.integers(0, 200, size=shape).astype(dtype) for _ in keys]
    return dict(zip(keys, arrs))


def native_or_skip():
    try:
        TS._native_lib()
    except RuntimeError as e:
        pytest.fail(f"the native library does not build: {e}")
    if TS._native_lib() is None:
        pytest.skip("no C++ compiler: the Python reader serves")


@pytest.mark.parametrize("code", DTYPE_CODES)
def test_stores_are_byte_equal_across_packages(tmp_path, code):
    recs = records_of(code)
    JS.write_store(str(tmp_path / "jax.gmm"), recs)
    TS.write_store(str(tmp_path / "port.gmm"), recs)
    assert (tmp_path / "jax.gmm").read_bytes() == \
        (tmp_path / "port.gmm").read_bytes()
    # each package reads the other's file
    for reader, path in ((TS.PyStoreReader, "jax.gmm"),
                         (JS.PyStoreReader, "port.gmm")):
        r = reader(str(tmp_path / path))
        assert len(r) == len(recs) and r.dtype == np.dtype(TS.DTYPES[code])
        for k, v in recs.items():
            np.testing.assert_array_equal(r.get(k), v)
        r.close()


@pytest.mark.parametrize("code", DTYPE_CODES)
def test_native_and_python_readers_agree(tmp_path, code):
    native_or_skip()
    recs = records_of(code, shape=(3, 5, 4))
    path = str(tmp_path / "s.gmm")
    TS.write_store(path, recs)
    nat, py = TS.NativeStoreReader(path), TS.PyStoreReader(path)
    assert (nat.shape, nat.dtype, len(nat)) == (py.shape, py.dtype, len(py))
    assert TS.DTYPE_CODES[nat.dtype] == code
    nat.prefetch(list(recs))
    for k in py.keys():
        a, b = nat.get(k), py.get(k)
        assert a.tobytes() == b.tobytes() == recs[k].tobytes()
        assert nat.get(k, copy=False).tobytes() == b.tobytes()
    with pytest.raises(KeyError):
        nat.get("missing")
    with pytest.raises(KeyError):
        py.get("missing")
    nat.close()
    py.close()
    r = TS.open_store(path)
    assert isinstance(r, TS.NativeStoreReader)
    r.close()
    assert isinstance(TS.open_store(path, prefer_native=False),
                      TS.PyStoreReader)


def test_native_library_builds_into_the_port_build_dir():
    native_or_skip()
    lib = TS.native_library_path()
    assert lib.exists() and lib.parent == TS.BUILD_DIR
    assert lib.parent.name == "build" and lib.parent.parent.name == \
        "gridmm_tpu_torch"
    assert TS.NATIVE_SRC.parent.name == "native"
    # no half-written file is left beside it
    assert not list(TS.BUILD_DIR.glob("libgmmstore-*.tmp"))


@pytest.mark.parametrize("code", [1, 2])
def test_streaming_writer_equals_one_shot_writer(tmp_path, code):
    recs = records_of(code, n=11, shape=(12, 50, 8))
    fetched = []

    def fetch(k):
        fetched.append(k)
        return recs[k]

    first = next(iter(recs.values()))
    TS.write_store_streaming(str(tmp_path / "stream.gmm"), list(recs)[::-1],
                             fetch, first.shape, first.dtype)
    TS.write_store(str(tmp_path / "shot.gmm"), recs)
    JS.write_store_streaming(str(tmp_path / "jax.gmm"), list(recs),
                             recs.__getitem__, first.shape, first.dtype)
    want = (tmp_path / "shot.gmm").read_bytes()
    assert (tmp_path / "stream.gmm").read_bytes() == want
    assert (tmp_path / "jax.gmm").read_bytes() == want
    assert fetched == sorted(recs)  # one record at a time, in key order


def test_bad_records_raise(tmp_path):
    long_key = "s" * TS.KEY_LEN
    ok = np.zeros((2, 3), np.float32)
    with pytest.raises(ValueError, match="key too long"):
        TS.write_store(str(tmp_path / "a.gmm"), {long_key: ok})
    with pytest.raises(ValueError, match="key too long"):
        TS.write_store_streaming(str(tmp_path / "b.gmm"), [long_key],
                                 lambda k: ok, ok.shape, ok.dtype)
    with pytest.raises(ValueError, match="mismatch"):
        TS.write_store(str(tmp_path / "c.gmm"),
                       {"a": ok, "b": np.zeros((3, 2), np.float32)})
    with pytest.raises(ValueError, match="mismatch"):
        TS.write_store(str(tmp_path / "d.gmm"),
                       {"a": ok, "b": ok.astype(np.float16)})
    with pytest.raises(ValueError, match="mismatch"):
        TS.write_store_streaming(str(tmp_path / "e.gmm"), ["a"],
                                 lambda k: ok.astype(np.float16), ok.shape,
                                 np.float32)
    (tmp_path / "bad.gmm").write_bytes(b"NOTASTORE" + bytes(64))
    with pytest.raises(ValueError, match="magic"):
        TS.PyStoreReader(str(tmp_path / "bad.gmm"))
