"""Port vs JAX package on the CPU: the preprocess stage and the bench
pipeline (data/preprocess.py, cli/preprocess.py, env/nav_graph.py,
pipeline.py).

Same numpy inputs and the flax weights carried by gridmm_tpu_torch.convert.
Integer outputs (depth, cell ids, masks, graph paths) must be equal; tokens
agree within 2e-4 (the tower bound of tests/test_pallas_attention_qkv.py:66)
and pooled features within 1e-4.
"""

import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import gridmm_tpu.data.preprocess as JD  # noqa: E402
import gridmm_tpu.models.clip_vit as JV  # noqa: E402
import gridmm_tpu_torch.data.preprocess as TD  # noqa: E402
import gridmm_tpu_torch.models.clip_vit as TV  # noqa: E402
from gridmm_tpu_torch.convert import load_flax_params  # noqa: E402
from torch_parity import assert_close, port_clip_config  # noqa: E402

VPS = [("scanA", f"vp{i}") for i in range(5)]


def test_synthetic_renderer_bit_identical():
    for seed in (0, 3):
        got = list(TD.synthetic_renderer(VPS, resolution=32, seed=seed))
        want = list(JD.synthetic_renderer(VPS, resolution=32, seed=seed))
        assert len(got) == len(want) == 5
        for (s, v, rgb, dep), (ws, wv, wrgb, wdep) in zip(got, want):
            assert (s, v) == (ws, wv)
            assert rgb.dtype == wrgb.dtype and dep.dtype == wdep.dtype
            np.testing.assert_array_equal(rgb, wrgb)
            np.testing.assert_array_equal(dep, wdep)


def test_extractor_matches_jax():
    """5 viewpoints, batch_panos=2 (a ragged last batch): same order, depth
    bit-exact, tokens within 2e-4."""
    jcfg = JV.ClipVisionConfig(input_resolution=64, patch_size=32, width=64,
                               layers=2, heads=4, compute_dtype="float32")
    jex = JD.ClipFeatureExtractor(jcfg, batch_panos=2)
    tower = load_flax_params(TV.ClipVisionTransformer(port_clip_config(jcfg)),
                             jax.tree.map(np.asarray, jex.params))
    tex = TD.ClipFeatureExtractor(port_clip_config(jcfg), tower,
                                  batch_panos=2, device="cpu")
    outs = {}
    for name, ex in (("jax", jex), ("port", tex)):
        rows = []
        n = ex.run(JD.synthetic_renderer(VPS, resolution=64),
                   lambda s, v, t, d: rows.append((s, v, t, d)))
        assert n == 5
        outs[name] = rows
    assert [r[:2] for r in outs["port"]] == [r[:2] for r in outs["jax"]] \
        == VPS
    for (_, _, tok, dep), (_, _, wtok, wdep) in zip(outs["port"],
                                                    outs["jax"]):
        assert tok.dtype == np.float32 and tok.shape == (12, 5, 64)
        np.testing.assert_array_equal(dep, wdep)
        assert_close(tok, wtok, rtol=2e-4, atol=2e-4)


def test_extractor_raises_renderer_errors():
    cfg = TV.ClipVisionConfig(input_resolution=64, patch_size=32, width=64,
                              layers=1, heads=4, compute_dtype="float32")
    ex = TD.ClipFeatureExtractor(cfg, batch_panos=2, device="cpu")

    def broken():
        yield from TD.synthetic_renderer(VPS[:3], resolution=64)
        raise OSError("renderer lost its dataset")

    try:
        ex.run(broken(), lambda s, v, t, d: None)
    except OSError as exc:
        assert "dataset" in str(exc)
    else:
        raise AssertionError("the renderer's error was swallowed")


def test_extractor_producer_stops_when_the_sink_raises():
    """A sink that raises on the first panorama ends the run with its
    error, and the render thread, blocked on the full queue behind it,
    is gone within a few seconds."""
    import threading
    import time

    cfg = TV.ClipVisionConfig(input_resolution=64, patch_size=32, width=64,
                              layers=1, heads=4, compute_dtype="float32")
    ex = TD.ClipFeatureExtractor(cfg, batch_panos=1, device="cpu")
    many = [("scanA", f"vp{i}") for i in range(40)]

    def sink(scan, vp, tokens, depth):
        raise RuntimeError("sink is full")

    before = set(threading.enumerate())
    try:
        ex.run(TD.synthetic_renderer(many, resolution=64), sink, prefetch=1)
    except RuntimeError as exc:
        assert "sink is full" in str(exc)
    else:
        raise AssertionError("the sink's error was swallowed")
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and \
            set(threading.enumerate()) - before:
        time.sleep(0.05)
    assert not set(threading.enumerate()) - before


def write_connectivity(root: Path):
    """A 4-node scan: a chain 0-1-2 with a shortcut 0-2, node 3 excluded."""
    root.mkdir()
    xyz = [(0.0, 0.0, 1.5), (1.0, 0.0, 1.5), (2.0, 0.5, 1.5), (5.0, 5.0, 1.5)]
    links = {(0, 1), (1, 2), (0, 2), (2, 3)}
    items = []
    for i, (x, y, z) in enumerate(xyz):
        pose = [0.0] * 16
        pose[3], pose[7], pose[11] = x, y, z
        unob = [(i, j) in links or (j, i) in links for j in range(4)]
        items.append({"image_id": f"vpP{i}", "included": i != 3,
                      "unobstructed": unob, "pose": pose, "height": 1.5})
    (root / "scanP_connectivity.json").write_text(json.dumps(items))
    (root / "scans.txt").write_text("scanP\n")
    return root


def test_nav_graph_matches_jax(tmp_path):
    from gridmm_tpu.env.nav_graph import load_nav_graphs as jax_load
    from gridmm_tpu_torch.env.nav_graph import load_nav_graphs

    conn = write_connectivity(tmp_path / "conn")
    got = load_nav_graphs(str(conn), ["scanP"])["scanP"]
    want = jax_load(str(conn), ["scanP"])["scanP"]
    assert got.adj == want.adj
    assert set(got.positions) == set(want.positions) == {"vpP0", "vpP1",
                                                         "vpP2"}
    gd, gp = got.all_pairs_tables()
    wd, wp = want.all_pairs_tables()
    for a in want.adj:
        assert dict(gd[a]) == dict(wd[a])
        assert {b: gp[a][b] for b in wp[a]} == {b: wp[a][b] for b in wp[a]}
    assert gp["vpP0"]["vpP2"] == ["vpP0", "vpP2"]
    assert TD.load_viewpoint_ids(str(conn)) == JD.load_viewpoint_ids(
        str(conn))
    assert TD.extract_viewpoint_info({"scanP": got}) == \
        JD.extract_viewpoint_info({"scanP": want})


def test_preprocess_cli_tiny_cpu(tmp_path):
    """The port's CLI writes the reference artifact set on the CPU, and the
    JAX package's Hdf5World reads it back."""
    from gridmm_tpu.env.world import Hdf5World
    from gridmm_tpu_torch.cli.preprocess import main

    conn = write_connectivity(tmp_path / "conn")
    out = tmp_path / "feats"
    n = main(["--connectivity_dir", str(conn), "--output_dir", str(out),
              "--renderer", "synthetic", "--tiny", "--resolution", "56",
              "--batch_panos", "2", "--device", "cpu"])
    assert n == 3
    info = json.loads((out / "viewpoint_info.json").read_text())
    assert info["scanP_vpP2"] == {"x": 2.0, "y": 0.5, "z": 1.5}
    world = Hdf5World(view_ft_file=str(out / "clip_p32.hdf5"),
                      depth_file=str(out / "depth.hdf5"),
                      grid_ft_file=str(out / "clip_p32.hdf5"),
                      viewpoint_info=info, image_feat_size=64)
    g = world.grid_features("scanP", "vpP0")
    assert g.shape == (12 * 49, 64) and np.isfinite(g).all()
    d = world.depth_patches("scanP", "vpP1")
    assert d.shape == (12, 49) and np.isfinite(d).all()


def test_preprocess_cli_imports_openai_checkpoint(tmp_path):
    """--clip_ckpt loads a saved OpenAI visual state dict into the tiny
    tower: the stored features are that tower's tokens (to f16)."""
    import h5py

    from gridmm_tpu_torch.cli.preprocess import load_clip_state_dict, main
    from gridmm_tpu_torch.utils.checkpoint import import_torch_clip_visual
    from torch_parity import openai_visual_state_dict

    sd = openai_visual_state_dict(layers=1)
    torch.save(sd, tmp_path / "clip.pt")
    loaded = load_clip_state_dict(str(tmp_path / "clip.pt"))
    assert set(loaded) == set(sd)
    conn = write_connectivity(tmp_path / "conn")
    out = tmp_path / "feats"
    main(["--connectivity_dir", str(conn), "--output_dir", str(out),
          "--renderer", "synthetic", "--tiny", "--resolution", "56",
          "--device", "cpu", "--clip_ckpt", str(tmp_path / "clip.pt")])
    cfg = TV.ClipVisionConfig(input_resolution=56, patch_size=8, width=64,
                              layers=1, heads=4, compute_dtype="float32")
    tower = import_torch_clip_visual(sd, TV.ClipVisionTransformer(cfg))
    (_, _, rgb, _), = TD.synthetic_renderer([("scanP", "vpP1")],
                                            resolution=56)
    with torch.no_grad():
        want = tower(TV.normalize_images(torch.from_numpy(rgb))).numpy()
    with h5py.File(out / "clip_p32.hdf5", "r") as f:
        got = f["scanP_vpP1"][...]
    # f16 storage: half an ulp (2^-11 relative) plus batch-size noise
    np.testing.assert_allclose(got.astype(np.float32), want,
                               rtol=2.0 ** -10, atol=1e-5)


def test_encode_and_pool_matches_jax():
    """The port's pipeline against the same composition of JAX functions
    (bench.py:95-114): 2 panoramas x 12 views at 224 px, patch 32, width 64,
    1 layer, f32 buffer of 2 steps driven 3 times (the third append clamps).
    Cell ids and masks equal, pooled within 1e-4."""
    import gridmm_tpu.ops.geometry as JG
    from gridmm_tpu.config import GridConfig as JGridConfig
    from gridmm_tpu.ops.grid_pool import (grid_scatter_pool,
                                          instruction_relevance)
    from gridmm_tpu_torch.config import GridConfig
    from gridmm_tpu_torch.ops import geometry as TG
    from gridmm_tpu_torch.pipeline import encode_and_pool

    b, v, t, d = 2, 12, 6, 64
    jcfg = JV.ClipVisionConfig(input_resolution=224, patch_size=32, width=d,
                               layers=1, heads=4, compute_dtype="float32")
    gkw = dict(feature_dim=d, max_steps=2)
    jgc, tgc = JGridConfig(**gkw), GridConfig(**gkw)
    jmodel = JV.ClipVisionTransformer(jcfg)
    params = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3))))
    tower = load_flax_params(TV.ClipVisionTransformer(port_clip_config(jcfg)),
                             params)
    rng = np.random.default_rng(0)
    wt, wg = (rng.standard_normal((d, d)).astype(np.float32) * 0.1
              for _ in range(2))
    bt, bg = (rng.standard_normal(d).astype(np.float32) * 0.1
              for _ in range(2))
    txt = rng.standard_normal((b, t, d)).astype(np.float32)

    jstate = JG.PointCloudState.create(b, jgc, jgc.max_points,
                                       feature_dtype=jnp.float32)
    tstate = TG.PointCloudState.create(b, tgc, tgc.max_points,
                                       feature_dtype=torch.float32,
                                       device="cpu")
    for step in range(3):
        images = rng.integers(0, 256, (b * v, 224, 224, 3)).astype(np.uint8)
        depth = rng.integers(0, 18000, (b, v, 49)).astype(np.float32)
        depth[rng.random(depth.shape) < 0.1] = 0.0
        pos = rng.uniform(-4, 4, (b, 2)).astype(np.float32)
        heading = rng.uniform(-3, 3, (b,)).astype(np.float32)

        tokens = jmodel.apply(params, JV.normalize_images(jnp.asarray(images)))
        patch = tokens[:, 1:, :].reshape(b, v * 49, d)
        w_new = instruction_relevance(patch, jnp.asarray(txt) @ wt + bt)
        jstate = JG.append_panorama(jstate, jnp.asarray(depth),
                                    patch @ wg + bg, jnp.asarray(pos), jgc,
                                    w_new)
        jcells, _, _ = JG.egocentric_grid_assignment(
            jstate, jnp.asarray(pos), jnp.asarray(heading), jgc)
        jpooled, jmask = grid_scatter_pool(jstate.features, jcells,
                                           jstate.weights)

        out = encode_and_pool(
            tower, torch.from_numpy(images), tstate, torch.from_numpy(depth),
            torch.from_numpy(pos), torch.from_numpy(heading),
            torch.from_numpy(txt), (torch.from_numpy(wt), torch.from_numpy(bt)),
            (torch.from_numpy(wg), torch.from_numpy(bg)), tgc)
        tstate = out.state
        np.testing.assert_array_equal(out.state.count.numpy(),
                                      np.asarray(jstate.count))
        np.testing.assert_array_equal(out.cells.numpy(), np.asarray(jcells))
        np.testing.assert_array_equal(out.cell_mask.numpy(),
                                      np.asarray(jmask))
        assert_close(out.pooled, jpooled, rtol=1e-4, atol=1e-4)
    assert (out.cells >= 0).any() and out.cell_mask.any()
