"""The plain references agree with the program on the CPU at tiny widths."""

import numpy as np
import torch

from benchmark.loops import nav
from benchmark.reference import navigator as R
from benchmark.tests.conftest import tiny_nav_conf


def models(train=False):
    from gridmm_tpu_torch.serve.engine import serving_cfg

    conf = tiny_nav_conf("r2r")
    cfg = nav.port_config(conf)
    if not train:
        cfg = serving_cfg(cfg)
        conf["model"]["compaction_stray_keys"] = False
    model, sd = nav.navigator(cfg, 7, "cpu")
    return conf, cfg, model, nav.reference_navigator(conf, sd)


def test_reference_holds_every_tensor_of_the_program():
    _, _, model, ref = models()
    assert set(model.state_dict()) == set(ref.state_dict())


def test_served_steps_agree():
    from gridmm_tpu_torch.train.step import init_carry, nav_device_step

    conf, cfg, model, ref = models()
    bank = nav.step_bank(cfg, np.random.default_rng(0), 4, 2)
    ids = torch.randint(1000, 30000, (2, cfg.shapes.max_txt_len))
    mask = torch.arange(cfg.shapes.max_txt_len)[None] < torch.tensor(
        [[9], [20]])
    ns = R.namespace(conf)
    with torch.no_grad():
        txt = model("language", {"txt_ids": ids, "txt_mask": mask})
        r_txt = ref.language(ids, mask)
        torch.testing.assert_close(r_txt, txt, rtol=1e-5, atol=1e-5)
        carry = init_carry(cfg, 2, device="cpu")
        r_carry = R.empty_carry(ns, 2, "cpu")
        for t in range(4):
            rows = [2 * t, 2 * t + 1]
            x = type(bank)(*(torch.as_tensor(np.concatenate(
                [f[r] for r in rows])) for f in bank))
            carry, out = nav_device_step(model, cfg, txt, mask, carry, x)
            r_carry, r_out = R.serve_step(
                ref, ns, r_txt, mask, r_carry,
                R.Steps(**{f: getattr(x, f) for f in R.Steps._fields}))
            for h in ("global", "local", "fused", "grid"):
                torch.testing.assert_close(getattr(r_out, f"{h}_logits"),
                                           getattr(out, f"{h}_logits"),
                                           rtol=1e-5, atol=1e-5)
        for a, b in zip(carry.point_state, r_carry.points):
            torch.testing.assert_close(b.double(), a.double(), rtol=1e-5,
                                       atol=1e-5)


def test_trajectory_loss_and_gradients_agree_with_dropout():
    from gridmm_tpu_torch.train.step import trajectory_loss

    from benchmark.loops import train

    conf, cfg, model, ref = models(train=True)
    model.train()
    ref.train()
    traffic = {"batch": 3, "steps": 4, "distinct_batches": 1}
    batch = train.make_batches(cfg, conf, traffic, 3, "cpu")[0][0]
    with train.dropout_seed(5, 0, "cpu"):
        loss = trajectory_loss(model, cfg, batch)
        loss.backward()
    steps = R.Steps(**{f: getattr(batch.steps, f) for f in R.Steps._fields})
    with train.dropout_seed(5, 0, "cpu"):
        r_loss = R.trajectory_loss(ref, R.namespace(conf), batch.txt_ids,
                                   batch.txt_mask, steps)
        # the reference holds the program's tensors: compare against a copy
        grads = {n: p.grad.clone() for n, p in model.named_parameters()
                 if p.grad is not None}
        for p in ref.parameters():
            p.grad = None
        r_loss.backward()
    torch.testing.assert_close(r_loss, loss, rtol=1e-5, atol=1e-6)
    for n, p in ref.named_parameters():
        g = grads.get(n, torch.zeros_like(p))
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        torch.testing.assert_close(got, g, rtol=1e-4, atol=1e-6)
