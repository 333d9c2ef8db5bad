"""Port vs JAX package: the real-data worlds and their small tools.

On annotation and feature files the tests write: the dataset loaders
(data/datasets.py), the HDF5 -> gmmstore converter (cli/convert_store.py),
the gmmstore world (env/world.GmmStoreWorld), `main_nav`'s real-data
builder (`build_real`, reference layout ROOT/R2R/{features,connectivity,
annotations}) and its CLI end to end, the tokenizer CLI with a stub
tokenizer (no tokenizer files are downloaded), and the visualization
helpers. Everything compared is equal: records, bytes, arrays and
observations."""

import copy
import gzip
import json
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import gridmm_tpu.cli.convert_store as JCONV  # noqa: E402
import gridmm_tpu.cli.main_nav as JCLI  # noqa: E402
import gridmm_tpu.cli.tokenize_instructions as JTOK  # noqa: E402
import gridmm_tpu.config as JC  # noqa: E402
import gridmm_tpu.data.datasets as JD  # noqa: E402
import gridmm_tpu.env.world as JW  # noqa: E402
import gridmm_tpu.utils.visualize as JV  # noqa: E402
import gridmm_tpu_torch.cli.convert_store as TCONV  # noqa: E402
import gridmm_tpu_torch.cli.main_nav as TCLI  # noqa: E402
import gridmm_tpu_torch.cli.tokenize_instructions as TTOK  # noqa: E402
import gridmm_tpu_torch.data.datasets as TD  # noqa: E402
import gridmm_tpu_torch.env.world as TW  # noqa: E402
import gridmm_tpu_torch.utils.visualize as TV  # noqa: E402
from torch_parity import port_config  # noqa: E402

h5py = pytest.importorskip("h5py")

D = 128   # tiny_config().model.image_feat_size: main_nav --tiny runs on it
NAMES = ("pth_vit_base_patch16_224_imagenet", "depth", "clip_p32")


def assert_same(a, b, path="obs"):
    """Recursive equality of observations: dicts, lists, arrays, scalars."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, (path, a, b)


def write_r2r_world(tmp_path, seed=3, n_eps=6):
    """A one-scan R2R world in the reference layout, HDF5 features of
    width D, each feature file also converted to gmmstore by the port's
    CLI (depth sliced to (12, 49) patch centers)."""
    from gridmm_tpu_torch.data.preprocess import extract_viewpoint_info
    from gridmm_tpu_torch.env.discrete import synthetic_episodes

    root = tmp_path / "R2R"
    feat, conn, anno = (root / "features", root / "connectivity",
                        root / "annotations")
    for p in (feat, conn, anno):
        p.mkdir(parents=True)
    world = TW.SyntheticWorld(num_scans=1, nodes_per_scan=6, feat_dim=D,
                              seed=seed)
    scan = world.scans()[0]
    g = world.graphs[scan]
    rng = np.random.default_rng(seed)
    with h5py.File(feat / f"{NAMES[0]}.hdf5", "w") as fv, \
            h5py.File(feat / f"{NAMES[1]}.hdf5", "w") as fd, \
            h5py.File(feat / f"{NAMES[2]}.hdf5", "w") as fg, \
            h5py.File(tmp_path / "aug_views.hdf5", "w") as fa:
        for vp in g.positions:
            key = f"{scan}_{vp}"
            fv[key] = world.view_features(scan, vp)
            fa[key] = rng.standard_normal((36, D)).astype(np.float32)
            fd[key] = rng.integers(100, 9000, (36, 128, 128)).astype(
                np.uint16)
            fg[key] = rng.standard_normal((12, 50, D)).astype(np.float16)
    (feat / "viewpoint_info.json").write_text(
        json.dumps(extract_viewpoint_info(world.graphs)))
    items = []
    vps = list(g.positions)
    for vp in vps:
        pose = [0.0] * 16
        pose[3], pose[7], pose[11] = g.positions[vp]
        items.append({"image_id": vp, "included": True,
                      "unobstructed": [n in g.neighbors(vp) for n in vps],
                      "pose": pose, "height": 1.5})
    (conn / f"{scan}_connectivity.json").write_text(json.dumps(items))
    eps = synthetic_episodes(world, num=n_eps, seed=seed, max_len=3)
    (anno / "R2R_train_enc.json").write_text(json.dumps(eps))
    (anno / "R2R_val_unseen_enc.json").write_text(json.dumps(eps[:4]))
    aug = [dict(e, instr_id=f"aug_{i}", path_id=f"aug_{i}")
           for i, e in enumerate(eps)]
    (tmp_path / "aug.json").write_text(json.dumps(aug))
    for name in NAMES:
        cargs = ["--input", str(feat / f"{name}.hdf5"),
                 "--output", str(feat / f"{name}.gmm")]
        if name == "depth":
            cargs.append("--slice-depth-patches")
        TCONV.main(cargs)
    return tmp_path


@pytest.fixture(scope="module")
def r2r_root(tmp_path_factory):
    return write_r2r_world(tmp_path_factory.mktemp("world"))


# ------------------------------------------------------------- datasets
def write_annotations(tmp_path):
    rng = np.random.default_rng(0)

    def item(i, n_instr=2):
        return {"path_id": 100 + i, "scan": f"scan{i % 2}",
                "path": [f"vp{j}" for j in range(3)], "heading": 0.5 * i,
                "instructions": [f"walk {i} {j}" for j in range(n_instr)],
                "instr_encodings": [
                    rng.integers(1, 900, size=int(rng.integers(5, 40))
                                 ).tolist() for _ in range(n_instr)]}

    (tmp_path / "R2R_train_enc.json").write_text(json.dumps(
        [item(i) for i in range(5)]))
    (tmp_path / "R2R_val_train_seen_enc.json").write_text(json.dumps(
        [item(i, 1) for i in range(60)]))
    rxr = [{"instr_id": f"rxr_{i}", "path_id": i, "scan": "s",
            "path": ["a", "b"], "instruction": "go",
            "instr_encoding": list(range(i * 7 + 3))} for i in range(6)]
    (tmp_path / "RXR_val_unseen_enc_xlmr.json").write_text(json.dumps(rxr))
    (tmp_path / "prevalent_aug.json").write_text(json.dumps(
        [item(i, 3) for i in range(4)]))


@pytest.mark.parametrize("dataset,splits,tok,max_len", [
    ("R2R", ["train"], "bert", 512),
    ("R2R", ["train", "val_train_seen"], "bert", 12),
    ("RXR", ["val_unseen"], "xlm", 20),
    ("R2R", ["AUG"], "bert", 30)])
def test_construct_instrs_matches_jax(tmp_path, dataset, splits, tok,
                                      max_len):
    write_annotations(tmp_path)
    splits = [str(tmp_path / "prevalent_aug.json") if s == "AUG" else s
              for s in splits]
    got = TD.construct_instrs(str(tmp_path), dataset, splits, tok, max_len)
    want = JD.construct_instrs(str(tmp_path), dataset, splits, tok, max_len)
    assert got == want and len(got) > 0
    assert all(len(x["instr_encoding"]) <= max_len for x in got)
    assert TD.load_instr_datasets(str(tmp_path), dataset, splits, tok) == \
        JD.load_instr_datasets(str(tmp_path), dataset, splits, tok)


def test_load_obj2vps_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    bbox = {f"scan{i % 3}_vp{i}": {
        f"{j}": {"visible_pos": rng.integers(0, 36, size=int(rng.integers(
            0, 4))).tolist()} for j in range(4)} for i in range(9)}
    (tmp_path / "BBoxes.json").write_text(json.dumps(bbox))
    got = TD.load_obj2vps(str(tmp_path / "BBoxes.json"))
    assert got == JD.load_obj2vps(str(tmp_path / "BBoxes.json"))
    assert got


class _ObjectWorld:
    """Detector objects at a viewpoint, raw radians (SOON contract)."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.objs = {}

    def objects(self, scan, vp):
        key = (scan, vp)
        if key not in self.objs:
            self.objs[key] = [
                {"obj_id": f"{vp}_o{k}",
                 "heading": float(self.rng.uniform(-np.pi, np.pi)),
                 "elevation": float(self.rng.uniform(-0.5, 0.5))}
                for k in range(6)]
        return self.objs[key]


def test_soon_pseudo_obj_labels_match_jax():
    rng = np.random.default_rng(2)
    data = []
    for i in range(12):
        goal = f"vp{i}"
        lo_h, lo_e = rng.uniform(0.0, 0.7), rng.uniform(0.2, 0.5)
        corners = {"left_top": (lo_h, lo_e + 0.3),
                   "right_top": (lo_h + 0.3, lo_e + 0.3),
                   "right_bottom": (lo_h + 0.3, lo_e),
                   "left_bottom": (lo_h, lo_e)}
        item = {"scan": "s", "path": ["a", goal]}
        if i % 4:
            item["bboxes"] = {goal: {"target": {
                c: {"heading": h, "elevation": e}
                for c, (h, e) in corners.items()}}}
        data.append(item)
    world = _ObjectWorld(3)
    got = TD.soon_pseudo_obj_labels(copy.deepcopy(data), world)
    want = JD.soon_pseudo_obj_labels(copy.deepcopy(data), world)
    assert got == want
    assert any("gt_obj_id" in x for x in got)


# ---------------------------------------------------- converted stores
@pytest.mark.parametrize("name,extra", [
    ("pth_vit_base_patch16_224_imagenet", []),
    ("depth", ["--slice-depth-patches"]),
    ("depth", ["--slice-depth-patches", "--dtype", "float32"]),
    ("clip_p32", ["--dtype", "float16"])])
def test_convert_store_is_byte_equal_to_jax(r2r_root, tmp_path, name, extra):
    src = r2r_root / "R2R" / "features" / f"{name}.hdf5"
    TCONV.main(["--input", str(src), "--output", str(tmp_path / "t.gmm"),
                *extra])
    JCONV.main(["--input", str(src), "--output", str(tmp_path / "j.gmm"),
                *extra])
    assert (tmp_path / "t.gmm").read_bytes() == \
        (tmp_path / "j.gmm").read_bytes()


@pytest.mark.parametrize("prefer_native", [True, False])
def test_gmmstore_world_matches_jax(r2r_root, prefer_native):
    feat = r2r_root / "R2R" / "features"
    vp_info = json.loads((feat / "viewpoint_info.json").read_text())
    files = [str(feat / f"{n}.gmm") for n in NAMES]
    tw = TW.GmmStoreWorld(*files, vp_info, image_feat_size=D,
                          prefer_native=prefer_native)
    jw = JW.GmmStoreWorld(*files, vp_info, image_feat_size=D,
                          prefer_native=False)
    h5 = TW.Hdf5World(*[str(feat / f"{n}.hdf5") for n in NAMES], vp_info,
                      image_feat_size=D)
    keys = list(vp_info)
    assert keys
    for key in keys:
        scan, vp = key.split("_", 1)
        for fn in ("view_features", "view_probs", "depth_patches",
                   "grid_features", "position"):
            got = getattr(tw, fn)(scan, vp)
            assert_same(got, getattr(jw, fn)(scan, vp), f"{fn} {key}")
            if fn != "view_probs":
                assert_same(got, getattr(h5, fn)(scan, vp), f"{fn} {key}")
    tw.prefetch([k.split("_", 1) for k in keys])
    tw.close()
    jw.close()


# ------------------------------------------------------------ build_real
def _tiny_cfgs():
    jcfg = JC.tiny_config()
    return jcfg, port_config(jcfg)


@pytest.mark.parametrize("extra", [
    ["--feature_backend", "gmmstore"],
    ["--feature_backend", "hdf5"],
    ["--feature_backend", "auto", "--aug", "AUG", "--aug_views", "VIEWS"]])
def test_build_real_matches_jax(r2r_root, extra):
    extra = [str(r2r_root / "aug.json") if a == "AUG"
             else str(r2r_root / "aug_views.hdf5") if a == "VIEWS" else a
             for a in extra]
    argv = ["--world", "r2r", "--root_dir", str(r2r_root), "--batch_size",
            "2", "--tiny", *extra]
    jcfg, tcfg = _tiny_cfgs()
    jenvs = JCLI.build_real(JCLI.parse_args(argv), jcfg)
    tenvs = TCLI.build_real(TCLI.parse_args(argv), tcfg)
    kinds = {"gmmstore": "GmmStoreWorld", "hdf5": "Hdf5World",
             "auto": "AugmentedViewWorld"}
    assert type(tenvs[0].world).__name__ == kinds[extra[1]]
    assert (tenvs[2] is None) == (jenvs[2] is None) == ("--aug" not in argv)
    for tenv, jenv in zip(tenvs, jenvs):
        if tenv is None:
            continue
        assert tenv.name == jenv.name
        assert_same(tenv.data, jenv.data, "data")
        for _ in range(3):  # wraps the 4-episode val split
            assert_same(tenv.reset(), jenv.reset())
        assert_same(tenv.batch, jenv.batch, "batch")


def test_main_nav_real_world_trains_end_to_end(r2r_root, tmp_path, capsys):
    res = TCLI.main(["--world", "r2r", "--root_dir", str(r2r_root),
                     "--feature_backend", "gmmstore", "--tiny",
                     "--device", "cpu", "--iters", "2", "--log_every", "1",
                     "--eval", "--batch_size", "2",
                     "--output_dir", str(tmp_path / "run"),
                     "--submit", str(tmp_path / "sub.json")])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["best_spl"] == res.best_spl
    assert np.isfinite(line["final_spl"]) and "final_nDTW" in line
    sub = json.loads((tmp_path / "sub.json").read_text())
    assert sorted(p["instr_id"] for p in sub) == sorted(
        e["instr_id"] for e in json.loads(
            (r2r_root / "R2R" / "annotations" / "R2R_val_unseen_enc.json"
             ).read_text()))


def test_main_nav_real_world_needs_root_dir():
    with pytest.raises(ValueError, match="--root_dir"):
        TCLI.main(["--world", "r2r", "--device", "cpu"])


# ---------------------------------------------------------- tokenizer
class _StubTokenizer:
    def encode(self, text, truncation=True, max_length=512):
        ids = [101] + [sum(map(ord, w)) % 30000 for w in text.split()] + \
            [102]
        return ids[:max_length] if truncation else ids


@pytest.mark.parametrize("fmt", ["r2r", "vlnce_gz", "single"])
def test_tokenize_instructions_writes_what_jax_writes(tmp_path, monkeypatch,
                                                      fmt):
    for mod in (TTOK, JTOK):
        monkeypatch.setattr(mod, "get_tokenizer", lambda name: _StubTokenizer())
    text = ["walk past the sofa and stop", "turn left at the long hall",
            "go up the stairs"]
    if fmt == "r2r":
        data = [{"path_id": i, "instructions": text[i:]} for i in range(3)]
    elif fmt == "vlnce_gz":
        data = {"episodes": [{"episode_id": i,
                              "instruction": {"instruction_text": t}}
                             for i, t in enumerate(text)]}
    else:
        data = [{"instr_id": i, "instruction": t} for i, t in
                enumerate(text)]
    suffix = ".json.gz" if fmt == "vlnce_gz" else ".json"
    src = tmp_path / f"in{suffix}"
    opener = gzip.open if suffix.endswith(".gz") else open
    with opener(src, "wt") as f:
        json.dump(data, f)
    outs = {}
    for tag, mod in (("t", TTOK), ("j", JTOK)):
        out = tmp_path / f"{tag}{suffix}"
        mod.main(["--input", str(src), "--output", str(out),
                  "--max_len", "6"])
        with opener(out, "rb") as f:
            outs[tag] = f.read()
    assert outs["t"] == outs["j"]
    assert b"101" in outs["t"]


# ---------------------------------------------------------- visualize
def test_visualize_matches_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(4)
    mask = rng.random(196) < 0.4
    scores = rng.standard_normal(196)
    for args in ((mask,), (mask, scores), (mask, np.full(196, np.nan)),
                 (np.zeros(196, bool), scores)):
        a, b = TV.grid_occupancy_image(*args), JV.grid_occupancy_image(*args)
        assert a.dtype == np.uint8 and a.shape == (224, 224, 3)
        np.testing.assert_array_equal(a, b)
    gt = rng.uniform(-5, 5, (6, 2))
    pred = rng.uniform(-5, 5, (4, 2))
    np.testing.assert_array_equal(TV.top_down_trajectory_image(gt, pred),
                                  JV.top_down_trajectory_image(gt, pred))
    img = TV.top_down_trajectory_image(gt, pred, size=64)
    TV.save_png(str(tmp_path / "t.png"), img)
    JV.save_png(str(tmp_path / "j.png"), img)
    TV.save_grid_png(str(tmp_path / "tg.png"), mask, scores)
    JV.save_grid_png(str(tmp_path / "jg.png"), mask, scores)
    frames = [rng.integers(0, 255, (16, 24, 3)).astype(np.uint8)
              for _ in range(3)]
    paths = [TV.save_episode_video(str(tmp_path / "tv"), frames),
             JV.save_episode_video(str(tmp_path / "jv"), frames)]
    assert paths[0].endswith(".gif") and paths[1].endswith(".gif")
    # without imageio: a filmstrip PNG in both
    monkeypatch.setitem(sys.modules, "imageio", None)
    paths += [TV.save_episode_video(str(tmp_path / "ts"), frames),
              JV.save_episode_video(str(tmp_path / "js"), frames)]
    assert paths[2].endswith(".png") and paths[3].endswith(".png")
    for t, j in (("t.png", "j.png"), ("tg.png", "jg.png"),
                 (paths[0], paths[1]), (paths[2], paths[3])):
        assert (tmp_path / t).read_bytes() == (tmp_path / j).read_bytes()


def test_allocate_episodes_by_scene_matches_jax():
    from gridmm_tpu.parallel.multihost import allocate_episodes_by_scene

    rng = np.random.default_rng(5)
    eps = [{"scan": f"s{int(k)}", "instr_id": i}
           for i, k in enumerate(rng.integers(0, 7, size=40))]
    for workers in (1, 3, 4):
        got = TCLI.allocate_episodes_by_scene(eps, workers)
        assert got == allocate_episodes_by_scene(eps, workers)
        assert sorted(e["instr_id"] for b in got for e in b) == list(
            range(40))
