"""Grid-pool forward and forward+backward: the kernels against the plain
ops, at the training replay shape (twin of scripts/bench_pool_bwd.py).

    python -m gridmm_tpu_torch.cli.bench_pool_bwd
    python -m gridmm_tpu_torch.cli.bench_pool_bwd --device cpu --tiny

For (B, N) = (8, 8820), (16, 8820) and (32, 8820) (15 steps x 588
points), D = 768 f32, cells drawn from [-1, 196), the loss sum(p^2) of the
pooled cells:

  * kernel: `ops/grid_pool.grid_pool` (GridPoolFunction: K1 forward, K5a
    and K5b backward on the card);
  * plain: `grid_scatter_pool_raw` differentiated by autograd, the
    yardstick that the JAX script's XLA formulation was.

Each time is the mean of 30 calls after 3 warm-up calls, queued and
synchronised once (host clock). Then the largest difference between the
two paths' gradients, absolute and relative to each gradient's max
(phase c of chip_smoke.py holds K5a's to 1e-5 and K5b's to 1e-4 of it).
On the CPU both paths are plain versions.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

SHAPES = ((8, 15), (16, 15), (32, 15))   # (B, steps of 588 points)


def bench(fn, args, device, iters: int = 30, warmup: int = 3) -> float:
    """Mean ms of fn(*args) over `iters` queued calls."""
    from gridmm_tpu_torch.utils import device as D

    for _ in range(warmup):
        fn(*args)
    D.sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    D.sync(device)
    return (time.perf_counter() - t0) / iters * 1e3


def run(device: str = "cuda", shapes=SHAPES, d: int = 768,
        iters: int = 30, seed: int = 0) -> dict:
    """{(B, N): {times in ms, "max_grad_err", "rel_grad_err"}}."""
    from gridmm_tpu_torch.ops.grid_pool import grid_pool, \
        grid_scatter_pool_raw
    from gridmm_tpu_torch.utils import device as D

    dev = D.resolve(device)
    print(f"device: {D.name(dev)}", flush=True)
    rng = np.random.default_rng(seed)
    out = {}
    for b, steps in shapes:
        n = steps * 588
        fts = torch.from_numpy(rng.standard_normal(
            (b, n, d), dtype=np.float32)).to(dev)
        cells = torch.tensor(rng.integers(-1, 196, size=(b, n)),
                             dtype=torch.int32, device=dev)
        w = torch.tensor(rng.standard_normal((b, n)), dtype=torch.float32,
                         device=dev)

        def fwd_plain(f, ww):
            with torch.no_grad():
                return grid_scatter_pool_raw(f, cells, ww)[0]

        def fwd_kernel(f, ww):
            with torch.no_grad():
                return grid_pool(f, cells, ww)[0]

        def grads(pool):
            def fb(f, ww):
                f = f.detach().requires_grad_(True)
                ww = ww.detach().requires_grad_(True)
                p = pool(f, cells, ww)[0]
                return torch.autograd.grad((p * p).sum(), (f, ww))
            return fb

        fb_plain, fb_kernel = grads(grid_scatter_pool_raw), grads(grid_pool)
        r = {"fwd_plain": bench(fwd_plain, (fts, w), dev, iters),
             "fwd_kernel": bench(fwd_kernel, (fts, w), dev, iters),
             "fwdbwd_plain": bench(fb_plain, (fts, w), dev, iters),
             "fwdbwd_kernel": bench(fb_kernel, (fts, w), dev, iters)}
        gp, gk = fb_plain(fts, w), fb_kernel(fts, w)
        errs = [(a - ref).abs().max().item() for a, ref in zip(gk, gp)]
        r["max_grad_err"] = max(errs)
        r["rel_grad_err"] = {
            name: e / max(ref.abs().max().item(), 1e-30)
            for name, e, ref in zip(("d_fts", "d_weights"), errs, gp)}
        print(f"B={b} N={n}: " + "  ".join(
            f"{k}={r[k]:.2f}ms" for k in ("fwd_plain", "fwd_kernel",
                                          "fwdbwd_plain", "fwdbwd_kernel"))
              + f"  max_grad_err={r['max_grad_err']:.2e} (d_fts "
              f"{r['rel_grad_err']['d_fts']:.1e}, d_weights "
              f"{r['rel_grad_err']['d_weights']:.1e} of their max)",
              flush=True)
        out[(b, n)] = r
        del fts, cells, w, gp, gk
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true",
                   help="B = 2, one step of 588 points, D = 16, 2 calls")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.tiny:
        return run(args.device, shapes=((2, 1),), d=16, iters=2)
    return run(args.device)


if __name__ == "__main__":
    main()
