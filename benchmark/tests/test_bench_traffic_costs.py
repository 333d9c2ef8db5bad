"""The traffic generators and the cost arithmetic."""

import numpy as np
import pytest

from benchmark.costs import grid_pool, navigator
from benchmark.loops import nav, serve
from benchmark.tests.conftest import tiny_nav_conf


def port_cfg():
    return nav.port_config(tiny_nav_conf("r2r"))


def bank(seed):
    return nav.step_bank(port_cfg(), np.random.default_rng(seed), 4, 2)


def test_step_bank_repeats_for_a_seed_and_not_for_another():
    a, b, c = bank(5), bank(5), bank(6)
    for x, y, z in zip(a, b, c):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a.patch_fts, c.patch_fts)
    assert not np.array_equal(a.depth, c.depth)


def test_step_bank_rows_follow_the_step_index():
    x = bank(1)
    cur = x.cur_node_idx[:, 0]
    np.testing.assert_array_equal(cur, np.repeat(np.arange(4), 2) + 1)
    assert (x.gmap_mask.sum(axis=-1)[:, 0] == cur + 4).all()
    # the three frontier slots are unvisited and gather local logits 1..3
    for r in range(len(cur)):
        np.testing.assert_array_equal(x.fused_add_idx[r, 0, cur[r] + 1:
                                                      cur[r] + 4], [1, 2, 3])
        assert not x.gmap_visited_mask[r, 0, cur[r] + 1:cur[r] + 4].any()


def source(seed, conf=None):
    conf = conf or tiny_nav_conf("r2r")
    traffic = {"episode_pool": 24}
    return serve.Source(conf, port_cfg(), traffic,
                        np.random.default_rng(seed), 2)


def test_episodes_repeat_for_a_seed_and_differ_in_order_for_another():
    sa, sb, sc = source(3), source(3), source(4)
    a = [sa.next() for _ in range(24)]
    b = [sb.next() for _ in range(24)]
    c = [sc.next() for _ in range(24)]
    assert [e.length for e in a] == [e.length for e in b]
    assert all(np.array_equal(x.rows, y.rows) for x, y in zip(a, b))
    # the same multiset of lengths in another order
    assert sorted(e.length for e in a) == sorted(e.length for e in c)
    assert [e.length for e in a] != [e.length for e in c] or any(
        not np.array_equal(x.ids, y.ids) for x, y in zip(a, c))


def test_length_pool_keeps_the_shares():
    parts = [{"share": 0.85, "min": 5, "max": 8},
             {"share": 0.15, "min": 9, "max": 15}]
    pool = nav.length_pool(parts, 480)
    assert len(pool) == 480
    assert ((pool >= 5) & (pool <= 8)).sum() == 408
    assert set(pool.tolist()) == set(range(5, 16))


def test_train_batches_repeat_for_a_seed():
    conf = tiny_nav_conf("r2r")
    traffic = {"batch": 3, "steps": 4, "distinct_batches": 2}
    from benchmark.loops import train

    a, va = train.make_batches(port_cfg(), conf, traffic, 9, "cpu")
    b, _ = train.make_batches(port_cfg(), conf, traffic, 9, "cpu")
    c, _ = train.make_batches(port_cfg(), conf, traffic, 10, "cpu")
    assert all(bool((x == y).all()) for x, y in zip(a[0].steps, b[0].steps))
    assert not bool((a[0].steps.patch_fts == c[0].steps.patch_fts).all())
    t = a[0].steps.target
    assert (t[0] != -100).all() and (t == 0).any()  # every row stops once
    assert (t == 0).sum() == 3


def test_linear_and_attention_counts():
    assert navigator.linear(3, 4, 5) == 120
    assert navigator.attention(2, 3, 4) == 96
    d, f, n = 8, 32, 5
    # q, k, v, out (4 x 2 n d d), scores and sum (4 n n d), FFN (4 n d f)
    assert navigator.self_layer(n, d, f) == 4 * 2 * n * d * d + \
        4 * n * n * d + 4 * n * d * f


def test_language_and_step_counts_at_r2r_widths():
    from benchmark import harness

    conf = harness.read_json(harness.HERE / "configs" / "r2r.json")
    # 9 BERT layers over 200 tokens, by hand: 4 projections of 2*200*768^2,
    # scores and sum 4*200^2*768, FFN 4*200*768*3072
    layer = (8 * 200 * 768 ** 2 + 4 * 200 ** 2 * 768
             + 4 * 200 * 768 * 3072)
    assert navigator.language(conf, 1) == 9 * layer
    assert navigator.serve_step(conf, 2) == 2 * navigator.serve_step(conf, 1)
    assert 1.5e10 < navigator.serve_step(conf, 1) < 2.5e10


def test_pool_bytes_by_hand():
    # 10 valid points of 4 features in f32, 2 rows of 16 points
    got = grid_pool.fwd_bytes(2, 16, 4, 10, 4)
    assert got == 10 * 4 * 4 + 2 * 16 * 8 + 2 * 196 * 4 * 4 + 2 * 196 \
        + 2 * 256 * 4 + 2 * 196 * 4
    got = grid_pool.bwd1_bytes(2, 16, 4, 10, 4)
    assert got == 10 * 16 + 2 * 16 * 16 + 2 * 196 * 16 + 2 * 16 * 12 \
        + 2 * (196 + 512) * 4


def test_trace_reduction_by_hand():
    from benchmark import harness

    dev = [(0, 10, "a"), (5, 20, "b"), (30, 40, "a"), (100, 110, "c")]
    spans = [(0, 50, "step"), (25, 35, "admit"), (50, 120, "fetch")]
    t = harness.reduce_trace(dev, spans, 120e-6)
    assert t["kernels"]["a"] == [2, pytest.approx(20e-6)]
    assert abs(t["busy_s"] - 40e-6) < 1e-12
    # gaps 20-30 (in step), 40-100 (in step, the innermost span at 40)
    assert [g[0] for g in t["idle_gaps"]] == ["step", "step"]
    assert abs(t["idle_gaps"][0][1] - 60e-6) < 1e-12
    assert t["spans"]["admit"] == [pytest.approx(10e-6)]
