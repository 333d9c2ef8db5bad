"""Optimizer zoo (twin of gridmm_tpu/train/optimizers.py).

The JAX package builds adamw/adam/rms/sgd/radam/rangerlars as optax chains
behind a global-norm clip (pretrain_src/optim/*, map_nav_src
agent_base.py:122-138), plus the linear warmup+decay schedule
(pretrain_src/optim/sched.py:18-29). `torch.optim` differs from those chains
in several places (RMSprop's decay 0.99 and eps outside the root, RAdam's
different rectification form and its threshold, no layerwise trust ratio),
so the update rules are written out here, operation for operation as optax
applies them, in one `torch.optim.Optimizer`.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Tuple, Union

import torch
from torch import nn

from gridmm_tpu_torch.config import TrainConfig

Schedule = Callable[[int], float]
RULES = ("adamw", "adam", "rms", "sgd", "radam", "rangerlars")


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    """{parameter name: True where weight decay applies}. The reference
    excludes biases and LayerNorm weights (pretrain_src/optim/misc.py:12-37,
    no_decay=['bias', 'LayerNorm.weight']); a LayerNorm here is any module
    whose class name ends in "LayerNorm"."""
    mask: Dict[str, bool] = {}
    for mod_name, mod in model.named_modules():
        is_ln = type(mod).__name__.endswith("LayerNorm")
        for p_name, _ in mod.named_parameters(recurse=False):
            full = f"{mod_name}.{p_name}" if mod_name else p_name
            mask[full] = not (is_ln or p_name == "bias")
    return mask


def warmup_linear_schedule(lr: float, warmup_steps: int,
                           total_steps: int) -> Schedule:
    """LR ramps 0 -> lr over warmup, then decays linearly to 0 (sched.py
    warmup_linear); a function of the number of updates already made."""
    decay_steps = max(total_steps - warmup_steps, 1)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return lr * min(count, warmup_steps) / warmup_steps
        frac = min(count - warmup_steps, decay_steps) / decay_steps
        return lr + (0.0 - lr) * frac

    return schedule


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over all tensors (optax.global_norm)."""
    return torch.sqrt(sum((t.detach().float() ** 2).sum() for t in tensors))


class ChainOptimizer(torch.optim.Optimizer):
    """clip_by_global_norm(clip) -> rule -> scale by -lr, as the optax chains
    of the JAX package (optimizers.py:87-111, step.py:76-87).

    `rule` is one of RULES. `lr` is a float or a schedule of the update
    count. `decay` maps a parameter (by identity) to whether weight decay
    applies (adamw only; None = every parameter). "rangerlars" is
    Lookahead(RAdam + layerwise trust ratio): every `sync_period` updates
    the slow weights move `slow_step_size` of the way to the fast ones and
    the fast ones restart from them (pretrain_src/optim/lookahead.py:29-52).
    """

    def __init__(self, params, rule: str, lr: Union[float, Schedule],
                 clip: float, betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 decay: Optional[Dict[torch.Tensor, bool]] = None,
                 sync_period: int = 6, slow_step_size: float = 0.5):
        if rule not in RULES:
            raise ValueError(f"unknown optimizer {rule!r}")
        super().__init__(params, {})
        self.rule = rule
        self.lr = lr
        self.clip = clip
        self.b1, self.b2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self._decay = decay
        self.sync_period = sync_period
        self.slow_step_size = slow_step_size
        self.count = 0            # updates made so far
        self.last_grad_norm: Optional[torch.Tensor] = None

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("ChainOptimizer takes no closure")
        params = [p for g in self.param_groups for p in g["params"]
                  if p.requires_grad]
        # a parameter the loss did not reach has a zero gradient, as under
        # jax.grad: its moments decay and weight decay still applies
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        g_norm = global_norm(grads)
        self.last_grad_norm = g_norm
        # optax: keep the gradient when g_norm < clip, else g / g_norm * clip
        keep = g_norm < self.clip
        lr = self.lr(self.count) if callable(self.lr) else self.lr
        t = self.count + 1
        for p, grad in zip(params, grads):
            g = torch.where(keep, grad, (grad / g_norm) * self.clip)
            st = self.state[p]
            u = getattr(self, f"_{self.rule}")(p, g, st, t)
            if self.rule == "rangerlars":
                self._lookahead(p, -lr * u, st, t)
            else:
                p.add_(u, alpha=-lr)
        self.count = t

    # ---- the rules: each returns the update direction before -lr ----
    def _moments(self, g, st, t):
        if "mu" not in st:
            st["mu"] = torch.zeros_like(g)
            st["nu"] = torch.zeros_like(g)
        st["mu"].mul_(self.b1).add_(g, alpha=1 - self.b1)
        st["nu"].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
        return (st["mu"] / (1 - self.b1 ** t), st["nu"] / (1 - self.b2 ** t))

    def _adam(self, p, g, st, t):
        mu_hat, nu_hat = self._moments(g, st, t)
        return mu_hat / (torch.sqrt(nu_hat) + self.eps)

    def _adamw(self, p, g, st, t):
        u = self._adam(p, g, st, t)
        if self._decay is None or self._decay[p]:
            u = u + self.weight_decay * p
        return u

    def _rms(self, p, g, st, t):
        # optax.rmsprop defaults: decay 0.9, eps 1e-8 inside the root
        if "nu" not in st:
            st["nu"] = torch.zeros_like(g)
        st["nu"].mul_(0.9).addcmul_(g, g, value=0.1)
        return g * torch.rsqrt(st["nu"] + 1e-8)

    def _sgd(self, p, g, st, t):
        return g

    def _radam(self, p, g, st, t):
        # optax.scale_by_radam: eps 1e-8 (cfg.adam_eps is not passed on),
        # rectified once ro >= 5
        mu_hat, nu_hat = self._moments(g, st, t)
        ro_inf = 2.0 / (1.0 - self.b2) - 1.0
        b2t = self.b2 ** t
        ro = ro_inf - 2 * t * b2t / (1 - b2t)
        if ro < 5.0:
            return mu_hat
        r = math.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                      / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
        return r * mu_hat / (torch.sqrt(nu_hat) + 1e-8)

    def _rangerlars(self, p, g, st, t):
        # optax.scale_by_trust_ratio: |p| / |u|, 1 where either norm is 0
        u = self._radam(p, g, st, t)
        p_norm, u_norm = torch.linalg.norm(p), torch.linalg.norm(u)
        ratio = torch.where((p_norm == 0) | (u_norm == 0),
                            torch.ones_like(p_norm), p_norm / u_norm)
        return u * ratio

    def _lookahead(self, p, fast_update, st, t):
        if "slow" not in st:
            st["slow"] = p.detach().clone()
        if t % self.sync_period == 0:
            fast = p + fast_update
            st["slow"].add_(fast - st["slow"], alpha=self.slow_step_size)
            p.add_(st["slow"] - p)
        else:
            p.add_(fast_update)

    def state_dict(self):
        sd = super().state_dict()
        sd["count"] = self.count
        return sd

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        self.count = state_dict.pop("count", 0)
        super().load_state_dict(state_dict)


def build_optimizer(name: str, cfg: TrainConfig, model: nn.Module,
                    schedule: Optional[Schedule] = None) -> ChainOptimizer:
    """The named rule behind the global-norm clip; adamw skips weight decay
    on biases and LayerNorm weights (`decay_mask`)."""
    named = dict(model.named_parameters())
    mask = decay_mask(model)
    return ChainOptimizer(
        named.values(), name,
        lr=schedule if schedule is not None else cfg.lr,
        clip=cfg.grad_norm_clip, betas=tuple(cfg.betas),
        eps=cfg.adam_eps, weight_decay=cfg.weight_decay,
        decay={p: mask[n] for n, p in named.items()})
