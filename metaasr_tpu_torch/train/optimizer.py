"""Outer optimizer and learning-rate schedule (counterpart of
``metaasr_tpu/train/optimizer.py``, which chains optax's
``clip_by_global_norm`` with adam/adamw/adadelta/sgd).

Written by hand with optax's arithmetic, in the same functional shape:
``init(params) -> state``, ``update(grads, state, params) -> (updates,
state)``, ``apply_updates(params, updates)``. Parameters, gradients and
updates are nested dicts of tensors (a Meta-SGD tree included). Details
kept from optax:

- the clip scales by ``max_norm / norm`` only when ``norm >= max_norm``
  (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm instead);
- the schedule is evaluated at the step count before it is incremented, so
  the first Noam step uses ``s = 1``;
- Adam's bias corrections use the incremented count.
"""

from __future__ import annotations

import torch

from metaasr_tpu_torch.config import OptimizerConfig
from metaasr_tpu_torch.utils.tree import flatten, unflatten_like


def noam_schedule(base_lr: float, d_model: int, warmup_steps: int):
    """Inverse-sqrt warmup: lr * d^-0.5 * min(s^-0.5, s * warmup^-1.5),
    s = step + 1, evaluated in float32 as the reference does."""

    def sched(step: int) -> float:
        s = torch.tensor(float(step), dtype=torch.float32) + 1.0
        v = base_lr * (d_model ** -0.5) * torch.minimum(
            s ** -0.5, s * warmup_steps ** -1.5)
        return float(v)

    return sched


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt(sum of squares over every leaf), as ``optax.global_norm``."""
    return torch.sqrt(sum(torch.sum(torch.square(v))
                          for v in flatten(tree).values()))


def apply_updates(params: dict, updates: dict) -> dict:
    u = flatten(updates)
    return unflatten_like(params, {k: p + u[k].to(p.dtype)
                                   for k, p in flatten(params).items()})


class Optimizer:
    """clip_by_global_norm(grad_clip) followed by the configured rule."""

    def __init__(self, cfg: OptimizerConfig, d_model: int = 256):
        if cfg.name not in ("adam", "adadelta", "sgd"):
            raise ValueError(f"unknown optimizer {cfg.name}")
        self.cfg = cfg
        self.lr = (noam_schedule(cfg.lr, d_model, cfg.warmup_steps)
                   if cfg.schedule == "noam" else (lambda step: cfg.lr))

    def init(self, params: dict) -> dict:
        zeros = {k: torch.zeros_like(v) for k, v in flatten(params).items()}
        state = {"count": 0}
        if self.cfg.name == "adam":
            state["mu"] = dict(zeros)
            state["nu"] = {k: torch.zeros_like(v) for k, v in zeros.items()}
        elif self.cfg.name == "adadelta":
            state["e_g"] = dict(zeros)
            state["e_x"] = {k: torch.zeros_like(v) for k, v in zeros.items()}
        return state

    def update(self, grads: dict, state: dict, params: dict):
        """-> (updates, new state); nothing is modified in place."""
        c = self.cfg
        g = flatten(grads)
        p = flatten(params)
        norm = global_norm(grads)
        g = {k: torch.where(norm < c.grad_clip, v,
                            (v / norm.to(v.dtype)) * c.grad_clip)
             for k, v in g.items()}
        count = state["count"]
        new = {"count": count + 1}
        if c.name == "adam":
            b1, b2 = c.adam_b1, c.adam_b2
            mu = {k: (1 - b1) * v + b1 * state["mu"][k] for k, v in g.items()}
            nu = {k: (1 - b2) * (v ** 2) + b2 * state["nu"][k]
                  for k, v in g.items()}
            t = torch.tensor(float(count + 1), dtype=torch.float32)
            bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** t)
            bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** t)
            u = {k: (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + c.adam_eps)
                 for k in g}
            if c.weight_decay > 0:
                u = {k: v + c.weight_decay * p[k] for k, v in u.items()}
            new["mu"], new["nu"] = mu, nu
        elif c.name == "adadelta":
            rho, eps = 0.9, 1e-6
            e_g = {k: (1 - rho) * (v ** 2) + rho * state["e_g"][k]
                   for k, v in g.items()}
            u = {k: (torch.sqrt(state["e_x"][k] + eps)
                     / torch.sqrt(e_g[k] + eps)) * v for k, v in g.items()}
            new["e_g"] = e_g
            new["e_x"] = {k: (1 - rho) * (v ** 2) + rho * state["e_x"][k]
                          for k, v in u.items()}
        else:
            u = g
        step = -self.lr(count) if c.name != "adadelta" else -c.lr
        return unflatten_like(grads, {k: step * v for k, v in u.items()}), new


def make_optimizer(cfg: OptimizerConfig, d_model: int = 256) -> Optimizer:
    return Optimizer(cfg, d_model)
