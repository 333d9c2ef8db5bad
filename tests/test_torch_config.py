"""The port's config mirrors the JAX package's, and the port imports no JAX."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import gridmm_tpu.config as JC  # noqa: E402
import gridmm_tpu_torch.config as TC  # noqa: E402
from torch_parity import DROPPED_MODEL_FIELDS  # noqa: E402

PRESETS = ["r2r", "reverie", "soon", "rxr", "r2r_ce", "rxr_ce", "tiny"]


@pytest.mark.parametrize("preset", PRESETS)
def test_presets_match_field_for_field(preset):
    j = getattr(JC, f"{preset}_config")()
    t = getattr(TC, f"{preset}_config")()
    for section in ("model", "grid", "shapes", "mesh", "train"):
        js, ts = getattr(j, section), getattr(t, section)
        jf = {f.name: getattr(js, f.name) for f in dataclasses.fields(js)}
        tf = {f.name: getattr(ts, f.name) for f in dataclasses.fields(ts)}
        if section == "model":
            assert DROPPED_MODEL_FIELDS <= set(jf)
            jf = {k: v for k, v in jf.items()
                  if k not in DROPPED_MODEL_FIELDS}
        assert tf == jf, section
    assert t.model.head_dim == j.model.head_dim
    assert t.grid.max_points == j.grid.max_points
    assert str(t.model.dtype) == f"torch.{j.model.dtype}"


def test_int8_matmuls_not_ported_yet():
    with pytest.raises(NotImplementedError):
        TC.ModelConfig(int8_matmuls=True)


def test_port_imports_no_jax():
    """Import every port module (and chip_smoke.py) in a fresh interpreter:
    no jax, flax, optax or gridmm_tpu module may be loaded."""
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in (ROOT / "gridmm_tpu_torch").rglob("*.py"))
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m
            for m in mods] + ["chip_smoke"]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'gridmm_tpu'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert len(mods) >= 15
