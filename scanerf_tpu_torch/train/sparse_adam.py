"""Sparse Adam for the hash tables (counterpart of
``scanerf_tpu/train/sparse_adam.py``, ``TrainConfig.sparse_adam``).

Per element: an int32 step count; the moments and the count move only
where the gradient is not exactly 0; the bias correction is taken at the
element's own count; the update is 0 elsewhere, so a table entry that no
ray touched this step neither moves nor decays its moments. The port's
table gradient is exactly 0 on every entry no row touched (B4 adds into a
zeroed buffer), which is the mask this needs. b1 0.9, b2 0.99, eps 1e-15,
as the JAX ``build_optimizer`` sets them.

It is not ``torch.optim.SparseAdam``, which takes sparse gradients and
keeps one step count for the whole tensor. The JAX package computes this
outside any Pallas kernel; here it is plain elementwise PyTorch, in place.
"""

from __future__ import annotations

import torch


class SparseAdam(torch.optim.Optimizer):
    """Adam with per-element counts that skips elements whose gradient is
    exactly 0 (the JAX ``scale_by_sparse_adam``), then the learning rate
    (optax's ``scale_by_learning_rate``: the caller sets each group's
    ``lr``). State per parameter, made at construction: ``count`` (int32,
    like the parameter), ``mu`` and ``nu``."""

    def __init__(self, params, lr: float = 0.0, betas=(0.9, 0.99), eps: float = 1e-15):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p] = {"count": torch.zeros_like(p, dtype=torch.int32),
                                 "mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("SparseAdam takes no closure")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                st = self.state[p]
                active = g != 0
                st["count"] += active.to(torch.int32)
                st["mu"].copy_(torch.where(active, b1 * st["mu"] + (1 - b1) * g, st["mu"]))
                st["nu"].copy_(torch.where(active, b2 * st["nu"] + (1 - b2) * g * g, st["nu"]))
                cf = st["count"].clamp_min(1).to(p.dtype)
                m_hat = st["mu"] / (1 - torch.pow(b1, cf))
                v_hat = st["nu"] / (1 - torch.pow(b2, cf))
                upd = torch.where(active, m_hat / (torch.sqrt(v_hat) + group["eps"]),
                                  torch.zeros_like(g))
                p.sub_(group["lr"] * upd)
