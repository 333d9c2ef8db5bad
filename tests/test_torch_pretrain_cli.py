"""The port's command lines on the CPU at tiny width: cli/pretrain.py
(synthetic batches, resume, an accumulation window, the --init_* glue
against the JAX CLI's, real data on the HDF5 fixture, the refusals),
cli/parity_eval.py against scripts/parity_eval.py (the same SR/SPL line in
both flavors), and export_serving --navigator_ckpt.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import torch  # noqa: E402

import gridmm_tpu.cli.pretrain as JCLI  # noqa: E402
import gridmm_tpu.utils.checkpoint as JCK  # noqa: E402
import gridmm_tpu_torch.cli.export_serving as TEXP  # noqa: E402
import gridmm_tpu_torch.cli.parity_eval as TPE  # noqa: E402
import gridmm_tpu_torch.cli.pretrain as TCLI  # noqa: E402
import gridmm_tpu_torch.utils.checkpoint as TCK  # noqa: E402
from gridmm_tpu.config import tiny_config as j_tiny  # noqa: E402
from gridmm_tpu.models.navigator import GridMMNavigator as JNav  # noqa: E402
from gridmm_tpu.models.navigator import init_navigator as j_init_nav  # noqa: E402
from gridmm_tpu_torch.models.navigator import init_navigator  # noqa: E402
from gridmm_tpu_torch.models.pretrain import GridMMPretrain  # noqa: E402
from torch_parity import port_config  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
import parity_eval as JPE  # noqa: E402

CPU = ["--device", "cpu"]


def json_lines(out):
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


# ----------------------------------------------------------------- config
@pytest.mark.parametrize("argv", [
    [], ["--preset", "r2r"], ["--full"], ["--preset", "reverie"],
    ["--preset", "soon"], ["--preset", "rxr"],
    ["--preset", "r2r", "--obj_ft_file", "o.hdf5"], ["--bf16"]],
    ids=["tiny", "r2r", "full", "reverie", "soon", "rxr", "r2r_objects",
         "bf16"])
def test_resolve_config_matches_jax(argv):
    """Every field equal to the JAX CLI's; at full presets the point buffer
    holds 21 steps (12,348 points padded to 12,416)."""
    got = TCLI._resolve_config(TCLI.parse_args(argv))
    want = JCLI._resolve_config(JCLI.parse_args(argv))
    assert got == port_config(want)
    if argv and argv[0] in ("--preset", "--full") and "rxr" not in argv:
        assert got.shapes.max_points == 12416 and got.grid.max_steps == 21


def test_argument_errors_and_refusals():
    assert TCLI.parse_args([]).device == "cuda"
    with pytest.raises(SystemExit):
        TCLI.parse_args(["--init_checkpoint", "a.pt",
                         "--init_pretrained", "bert", "--init_weights", "b"])
    with pytest.raises(SystemExit):
        TCLI.parse_args(["--init_pretrained", "lxmert"])
    # the parallel layer is ported: an --mp_size the world of one does not
    # divide raises the JAX mesh error
    assert TCLI.parse_args(["--mesh", "auto"]).mesh == "auto"
    with pytest.raises(ValueError, match=r"mesh 0x2 != 1 devices"):
        TCLI.main(["--mesh", "auto", "--mp_size", "2"] + CPU)
    with pytest.raises(ValueError, match="--mix_ratio"):
        TCLI.main(CPU + ["--tasks", "mlm,sap", "--mix_ratio", "1"])


# ------------------------------------------------------- synthetic + resume
def test_cli_synthetic_then_resume(tmp_path, capsys):
    """Three updates with a save every 3 and a validation, on the CPU; the
    navigator file loads strictly into a navigator (main_nav --resume);
    then a resumed run continues from update 3 to 5 with the optimizer's
    count restored."""
    out = str(tmp_path / "run")
    state = TCLI.main(CPU + ["--steps", "3", "--valid_every", "3",
                             "--save_every", "3", "--output_dir", out])
    assert state.step == 3 and state.optimizer.count == 3
    lines = json_lines(capsys.readouterr().out)
    assert lines[-1]["step"] == 3
    assert {"mlm_acc", "mrc_acc", "sap_acc", "sap_gacc",
            "sap_lacc"} <= set(lines[-1])
    ckpts = tmp_path / "run" / "ckpts"
    assert {p.name for p in ckpts.iterdir()} == {"latest", "step_3",
                                                  "navigator_latest"}
    cfg = TCLI._resolve_config(TCLI.parse_args([]))
    nav = init_navigator(cfg.model, seed=9, device="cpu")
    TCK.restore_checkpoint(str(ckpts / "navigator_latest"), nav)
    assert torch.equal(nav.text_proj.weight,
                       state.model.bert.text_proj.weight)
    saved = TCK.restore_checkpoint(str(ckpts / "latest"))

    resumed = TCLI.main(CPU + ["--steps", "2", "--valid_every", "2",
                               "--output_dir", out, "--resume",
                               str(ckpts / "latest")])
    assert json_lines(capsys.readouterr().out)[0] == {"resumed_step": 3}
    assert resumed.step == 5 and resumed.optimizer.count == 5
    w = "bert.embeddings.word_embeddings.weight"
    assert not torch.equal(resumed.model.state_dict()[w], saved["model"][w])


def test_cli_accumulation_window(tmp_path):
    """--accum_steps 2: each optimizer step consumes two microbatches of
    one task."""
    state = TCLI.main(CPU + ["--steps", "2", "--accum_steps", "2",
                             "--tasks", "sap,mrc", "--mix_ratio", "1,1",
                             "--valid_every", "2", "--output_dir",
                             str(tmp_path)])
    assert state.step == 2 and state.optimizer.count == 2


# ------------------------------------------------------------ --init_* glue
def _init_file(tmp_path, kind, cfg):
    """A torch file in the key space of each --init_* flavor, synthesized
    by the JAX package on its pretrain tree (tensors, as released files
    hold them)."""
    from gridmm_tpu.models.pretrain import GridMMPretrain as JPretrain
    from gridmm_tpu.train.pretrain import init_pretrain_params
    from gridmm_tpu.train.synthetic import synthetic_pretrain_batch
    from tests.test_pretrain_init import _hf_bert_sd, _lxmert_sd

    model = JPretrain(cfg.model)
    batch = synthetic_pretrain_batch(cfg, 2, 3)
    params = jax.jit(lambda k: init_pretrain_params(model, cfg, k, batch))(
        jax.random.PRNGKey(0))
    m = cfg.model
    kw = dict(num_l_layers=m.num_l_layers, num_x_layers=m.num_x_layers,
              num_pano_layers=m.num_pano_layers, has_obj=False)
    if kind == "checkpoint":
        sd = JCK.synthesize_torch_state_dict(JCK.pretrain_rules(**kw),
                                             params, seed=2)
        sd = {"model": sd}
    elif kind == "bert":
        sd = _hf_bert_sd(params, kw)
    else:
        sd = _lxmert_sd(params, kw)

    def tensors(tree):
        if isinstance(tree, dict):
            return {k: tensors(v) for k, v in tree.items()}
        return torch.from_numpy(np.asarray(tree))

    path = tmp_path / f"{kind}.pt"
    torch.save(tensors(sd), str(path))
    return path


@pytest.mark.parametrize("kind", ["checkpoint", "bert", "lxmert"])
def test_cli_init_glue_matches_jax(tmp_path, capsys, kind):
    """--init_checkpoint, --init_pretrained bert (with
    --init_fill_lang_encoder) and lxmert: the port's _apply_init_weights
    fills the same leaves as the JAX CLI's and prints the same line; a
    pretrain run starts from it; a file in another key space raises."""
    argv = (["--init_checkpoint"] if kind == "checkpoint" else
            ["--init_pretrained", kind, "--init_weights"])
    jcfg = JCLI._resolve_config(JCLI.parse_args([]))
    path = _init_file(tmp_path, kind, jcfg)
    argv = argv + [str(path)]
    if kind == "bert":
        argv.append("--init_fill_lang_encoder")

    from gridmm_tpu.models.pretrain import GridMMPretrain as JPretrain
    from gridmm_tpu.train.pretrain import init_pretrain_params
    from gridmm_tpu.train.synthetic import synthetic_pretrain_batch

    jparams = jax.jit(lambda k: init_pretrain_params(
        JPretrain(jcfg.model), jcfg, k,
        synthetic_pretrain_batch(jcfg, 2, 3)))(jax.random.PRNGKey(1))
    capsys.readouterr()
    JCLI._apply_init_weights(JCLI.parse_args(argv), jcfg, jparams)
    want = json_lines(capsys.readouterr().out)
    tcfg = TCLI._resolve_config(TCLI.parse_args(argv))
    model = GridMMPretrain(tcfg.model)
    TCLI._apply_init_weights(TCLI.parse_args(argv), tcfg, model)
    got = json_lines(capsys.readouterr().out)
    assert got == want and got[0]["init_filled_leaves"] > 0

    state = TCLI.main(CPU + argv + ["--steps", "1", "--valid_every", "1",
                                    "--output_dir", str(tmp_path / "o")])
    assert state.step == 1
    assert json_lines(capsys.readouterr().out)[0] == got[0]

    bad = tmp_path / "bad.pt"
    torch.save({"who.knows.weight": torch.zeros(3, 3)}, str(bad))
    bad_argv = argv[:-2 if kind == "bert" else -1] + [str(bad)]
    with pytest.raises(ValueError, match="ZERO parameters"):
        TCLI._apply_init_weights(TCLI.parse_args(bad_argv), tcfg, model)



# -------------------------------------------------------------- real data
def test_cli_real_data_with_objects(tmp_path, capsys):
    """--traj_files on the HDF5 fixture (reference layout) with an object
    store: the sap and og tasks train and validate over the full val
    split."""
    pytest.importorskip("h5py")
    from tests.test_pretrain_cli_realdata import _base_args, build_fixture

    traj = build_fixture(tmp_path, with_objects=True)
    state = TCLI.main(CPU + _base_args(tmp_path, traj) + [
        "--obj_ft_file", str(tmp_path / "objects.hdf5"),
        "--tasks", "sap,og", "--mix_ratio", "1,1", "--steps", "2",
        "--valid_every", "2"])
    assert state.step == 2
    last = json_lines(capsys.readouterr().out)[-1]
    assert {"og_acc", "sap_acc"} <= set(last)
    assert 0.0 <= last["og_acc"] <= 1.0


# ------------------------------------------------------------ parity_eval
def _navigator_sd(cfg=None):
    cfg = cfg or j_tiny()
    params = j_init_nav(JNav(cfg.model), cfg.shapes, jax.random.PRNGKey(0))
    rules = JCK.navigator_rules(cfg.model.num_l_layers,
                                cfg.model.num_x_layers,
                                cfg.model.num_pano_layers, has_obj=False)
    return JCK.synthesize_torch_state_dict(rules, params)


@pytest.mark.parametrize("flavor", ["finetune", "pretrain"])
def test_parity_eval_dry_run_matches_jax(tmp_path, capsys, flavor):
    """The synthetic dry run of both flavors (grid_map.pt nesting with
    'module.vln_bert.' keys; a pretrain ModelSaver dict with 'bert.' trunk
    keys and pretrain heads): the port prints the same SR/SPL line as
    scripts/parity_eval.py."""
    sd = _navigator_sd()
    if flavor == "finetune":
        ckpt = {"vln_bert": {"epoch": 1, "optimizer": {},
                             "state_dict": {"module.vln_bert." + k:
                                            torch.from_numpy(v)
                                            for k, v in sd.items()}},
                "critic": {"state_dict": {}}}
    else:
        ckpt = {("" if k.split(".")[0].endswith(("_head", "_linear"))
                 else "bert.") + k: torch.from_numpy(v)
                for k, v in sd.items()}
        ckpt["mlm_head.predictions.bias"] = torch.zeros(10)
    path = tmp_path / "ckpt.pt"
    torch.save(ckpt, str(path))
    argv = ["--world", "synthetic", "--navigator_ckpt", str(path),
            "--flavor", flavor, "--batch_size", "4", "--eval_batches", "2"]
    capsys.readouterr()
    JPE.main(argv)
    want = json_lines(capsys.readouterr().out)
    got_metrics = TPE.main(argv + CPU)
    got = json_lines(capsys.readouterr().out)
    assert got == want and "spl" in got[-1] and "sr" in got_metrics


def test_parity_eval_refuses_a_wrong_key_space(tmp_path):
    path = tmp_path / "bad.pt"
    torch.save({"who.knows.weight": torch.zeros(3, 3)}, str(path))
    with pytest.raises(ValueError, match="unfilled"):
        TPE.main(["--world", "synthetic", "--navigator_ckpt", str(path)]
                 + CPU)
    with pytest.raises(ValueError, match="--root_dir"):
        TPE.main(["--world", "r2r", "--navigator_ckpt", str(path)] + CPU)


# --------------------------------------------------- export --navigator_ckpt
def test_export_serving_imports_a_released_checkpoint(tmp_path, capsys):
    """export_serving --navigator_ckpt on a grid_map.pt-nested file: the
    bundle's manifest names navigator.pt, which holds exactly the imported
    weights (equal to the JAX package's import, as the converter carries
    it) and loads strictly into a navigator."""
    from gridmm_tpu_torch.convert import flax_to_state_dict

    cfg = j_tiny()
    sd = _navigator_sd(cfg)
    ckpt = {"vln_bert": {"epoch": 0, "optimizer": {},
                         "state_dict": {"vln_bert." + k: torch.from_numpy(v)
                                        for k, v in sd.items()}}}
    path = tmp_path / "grid_map.pt"
    torch.save(ckpt, str(path))
    out = tmp_path / "bundle"
    man = TEXP.main(["--tiny", "--device", "cpu", "--batch", "1",
                     "--max_action_len", "3", "--navigator_ckpt", str(path),
                     "--out_dir", str(out)])
    assert man["weights"] == "navigator.pt"
    assert (out / "nav_step.pt2").exists()
    saved = TCK.restore_checkpoint(str(out / "navigator.pt"))
    template = j_init_nav(JNav(cfg.model), cfg.shapes,
                          jax.random.PRNGKey(0))
    jparams, _ = JCK.import_torch_navigator(
        JCK.remap_ce_released(ckpt), template,
        num_l_layers=cfg.model.num_l_layers,
        num_x_layers=cfg.model.num_x_layers,
        num_pano_layers=cfg.model.num_pano_layers)
    nav = init_navigator(port_config(cfg).model, seed=3, device="cpu")
    want = flax_to_state_dict(jax.tree.map(np.asarray, jparams), nav)
    assert set(saved) == set(want)
    for k in want:
        assert torch.equal(saved[k], want[k]), k
    nav.load_state_dict(saved, strict=True)

