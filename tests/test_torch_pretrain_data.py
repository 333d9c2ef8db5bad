"""Port vs JAX package: the pretraining dataset on the CPU.

`random_word_masking` (the same `random.Random` call order),
`load_trajectory_jsonl`, `TextPathDataset.get_input` for every end-viewpoint
type and flavor, and `build_batch` for every task, on a tiny on-disk
fixture in the reference layout (HDF5 stores, connectivity, viewpoint info,
trajectory jsonl; tests/test_pretrain_cli_realdata.build_fixture). Ids,
labels and masks equal; floats within 1e-6, the cell positional features
within 1e-5 (FLOAT_ATOL).
"""

import random
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import gridmm_tpu.data.pretrain_data as JD  # noqa: E402
import gridmm_tpu_torch.data.pretrain_data as TD  # noqa: E402
from gridmm_tpu.config import tiny_config  # noqa: E402
from gridmm_tpu.env.nav_graph import load_nav_graphs as j_graphs  # noqa: E402
from gridmm_tpu.env.world import Hdf5ObjectWorld as JObjWorld  # noqa: E402
from gridmm_tpu.env.world import Hdf5World as JWorld  # noqa: E402
from gridmm_tpu_torch.env.nav_graph import load_nav_graphs as t_graphs  # noqa: E402
from gridmm_tpu_torch.env.world import Hdf5ObjectWorld as TObjWorld  # noqa: E402
from gridmm_tpu_torch.env.world import Hdf5World as TWorld  # noqa: E402
from torch_parity import port_config, to_numpy  # noqa: E402

pytest.importorskip("h5py")
from tests.test_pretrain_cli_realdata import SCAN, build_fixture  # noqa: E402


# The cell positional features come out of f32 atan2/sin/cos in XLA on one
# side and in PyTorch on the other; tests/test_torch_geometry.py holds
# gridmap_pos_fts to 1e-5, and so does this file. Every other float is a
# copy or a host float64 computation: 1e-6.
FLOAT_ATOL = {"gridmap_pos_fts": 1e-5}


def assert_same(got, want, what):
    """Integers and bools equal, floats within 1e-6 (FLOAT_ATOL); same
    dtype."""
    got, want = to_numpy(got), np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.floating):
        atol = FLOAT_ATOL.get(what.split()[-1], 1e-6)
        np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_word_masking_equals_jax(seed):
    """Same ids, labels and generator state after the call, also on a
    3-token sequence whose draw may mask nothing (position 0 then)."""
    rs = np.random.default_rng(seed)
    for n in (3, 40):
        ids = rs.integers(1000, 29000, size=n).astype(np.int32)
        ja, ta = random.Random(seed), random.Random(seed)
        want = JD.random_word_masking(ids, ja)
        got = TD.random_word_masking(ids, ta)
        for g_, w_ in zip(got, want):
            np.testing.assert_array_equal(g_, w_)
        assert ja.getstate() == ta.getstate()


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("pretrain_fixture")
    traj = build_fixture(root, with_objects=True)
    return root, traj


def _worlds(root, objects, cfg):
    import json

    vp_info = json.loads((root / "viewpoint_info.json").read_text())
    kw = dict(view_ft_file=str(root / "views.hdf5"),
              depth_file=str(root / "depth.hdf5"),
              grid_ft_file=str(root / "grid.hdf5"), viewpoint_info=vp_info,
              image_feat_size=cfg.model.image_feat_size)
    if objects:
        okw = dict(obj_ft_file=str(root / "objects.hdf5"), max_objects=20,
                   angle_feat_size=cfg.model.angle_feat_size)
        return JObjWorld(**kw, **okw), TObjWorld(**kw, **okw)
    return JWorld(**kw), TWorld(**kw)


def _datasets(root, traj, flavor, objects=False, seed=0):
    import dataclasses

    jcfg = tiny_config()
    m = dataclasses.replace(jcfg.model, image_prob_size=16)
    if objects:
        m = dataclasses.replace(m, obj_feat_size=m.image_feat_size)
        jcfg = dataclasses.replace(jcfg, shapes=dataclasses.replace(
            jcfg.shapes, max_obj_len=20))
    jcfg = dataclasses.replace(jcfg, model=m)
    tcfg = port_config(jcfg)
    jdata = JD.load_trajectory_jsonl([str(traj)])
    tdata = TD.load_trajectory_jsonl([str(traj)])
    assert tdata == jdata
    if flavor != "r2r":
        for d in (jdata, tdata):   # REVERIE-style positives: the last two
            for it in d:
                it["pos_vps"] = it["path"][-2:]
    jworld, tworld = _worlds(root, objects, jcfg)
    conn = str(root / "connectivity")
    jds = JD.TextPathDataset(jdata, jworld, j_graphs(conn, [SCAN]), jcfg,
                             seed=seed, flavor=flavor)
    tds = TD.TextPathDataset(tdata, tworld, t_graphs(conn, [SCAN]), tcfg,
                             seed=seed, flavor=flavor)
    return jds, tds


@pytest.mark.parametrize("flavor", ["r2r", "reverie", "soon"])
def test_get_input_equals_jax(fixture_dir, flavor):
    """Every item under every end-viewpoint type: each array of the item
    equal (floats within 1e-6), the labels and the sampled path equal, and
    the two datasets' generators in the same state after."""
    root, traj = fixture_dir
    jds, tds = _datasets(root, traj, flavor)
    for idx in range(len(jds)):
        for end in ("pos", "neg_in_gt_path", "neg_others"):
            want = jds.get_input(idx, end)
            got = tds.get_input(idx, end)
            assert set(got) == set(want)
            for k, w in want.items():
                if k == "last_scan_vp":
                    assert got[k] == w
                else:
                    assert_same(got[k], w, f"{flavor} {idx} {end} {k}")
    assert jds.rng.getstate() == tds.rng.getstate()


@pytest.mark.parametrize("task,objects", [("mlm", False), ("mrc", False),
                                          ("sap", False), ("og", True)])
def test_build_batch_equals_jax(fixture_dir, task, objects):
    """build_batch over three index sets: every PretrainBatch field equal
    (ids, labels and masks exactly, floats within 1e-6), returned as CPU
    tensors."""
    root, traj = fixture_dir
    jds, tds = _datasets(root, traj, "r2r", objects=objects, seed=3)
    for idx in ([0, 1], [2, 3, 4], [5, 6]):
        want = jds.build_batch(idx, task)
        got = tds.build_batch(idx, task)
        for f in want._fields:
            t = getattr(got, f)
            assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
            assert_same(t, getattr(want, f), f"{task} {idx} {f}")
        if task == "og":
            assert (to_numpy(got.obj_labels) >= 0).any()
    assert jds.rng.getstate() == tds.rng.getstate()


def test_unknown_flavor_raises(fixture_dir):
    root, traj = fixture_dir
    with pytest.raises(ValueError, match="flavor"):
        _datasets(root, traj, "rxr-ce")


def test_batches_run_through_the_port_model(fixture_dir):
    """A collated batch of each task gives a finite, non-negative loss on
    the port's model (tiny, CPU)."""
    from gridmm_tpu_torch.train.pretrain import init_pretrain_params, task_loss

    root, traj = fixture_dir
    _, tds = _datasets(root, traj, "r2r", objects=True)
    model = init_pretrain_params(tds.cfg.model, seed=0, device="cpu")
    with torch.no_grad():
        for task in ("mlm", "mrc", "sap", "og"):
            loss = task_loss(model, tds.build_batch([0, 1], task), task)
            assert np.isfinite(loss.item()) and loss.item() >= 0, task
