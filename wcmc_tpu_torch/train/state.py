"""Per-model optimizer: gradient clipping, Adam and an optional warmup.

Counterpart of ``wcmc_tpu/train/state.py``.  The reference threads a
functional ``(params, opt_state)`` pair per model through its jitted
step; here each model is an ``nn.Module`` that holds its parameters and
gradients, and each has one :class:`AdamWithClip`.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch


class AdamWithClip:
    """The reference's optax chain, applied to the parameters' ``.grad``:

    1. value clip to ``[-clip_value, clip_value]`` (KPCN);
    2. global-norm clip to ``clip_norm`` (optax's rule: gradients whose
       global norm is at least ``clip_norm`` are scaled to it);
    3. Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8, eps_root 0)
       at the mutable learning rate ``lr``;
    4. with ``warmup_steps``, the update scaled by ``min(1, (t + 1) /
       warmup_steps)`` at step t (counted from 0).

    Adam scales its update linearly with the learning rate, so the warmup
    runs as a learning rate of ``lr`` times the ramp for that step.  The
    clips work on ``.grad`` in place, as ``torch.nn.utils``' clips do.
    """

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float,
                 clip_value: Optional[float] = None,
                 clip_norm: Optional[float] = None, warmup_steps: int = 0):
        self.params = [p for p in params if p.requires_grad]
        self.lr = float(lr)
        self.clip_value, self.clip_norm = clip_value, clip_norm
        self.warmup_steps = warmup_steps
        self.count = 0
        self.adam = torch.optim.Adam(self.params, lr=self.lr, betas=(0.9, 0.999), eps=1e-8)

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def _clip(self, grads):
        if self.clip_value is not None:
            torch.nn.utils.clip_grad_value_(self.params, self.clip_value)
        if self.clip_norm is not None and grads:
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g.float()) for g in grads]))
            scale = torch.where(norm < self.clip_norm, torch.ones_like(norm),
                                self.clip_norm / norm)
            torch._foreach_mul_(grads, scale)

    @torch.no_grad()
    def step(self):
        grads = [p.grad for p in self.params if p.grad is not None]
        self._clip(grads)
        ramp = 1.0
        if self.warmup_steps:
            ramp = min(1.0, (self.count + 1) / self.warmup_steps)
        for group in self.adam.param_groups:
            group["lr"] = self.lr * ramp
        self.adam.step()
        self.count += 1


def adam_with_clip(params, lr, clip_value: float | None = None,
                   clip_norm: float | None = None, warmup_steps: int = 0) -> AdamWithClip:
    return AdamWithClip(params, lr, clip_value, clip_norm, warmup_steps)


def set_learning_rate(opt, lr):
    """Set the mutable learning rate of an optimizer.  Raises when it
    holds none, so an epoch scheduler cannot silently do nothing."""
    if not isinstance(opt, AdamWithClip):
        raise ValueError(f"set_learning_rate found no learning rate in {type(opt).__name__}")
    opt.lr = float(lr)
    return opt


def get_learning_rate(opt) -> float:
    if not isinstance(opt, AdamWithClip):
        raise ValueError(f"get_learning_rate found no learning rate in {type(opt).__name__}")
    return opt.lr


def param_count(module_or_params) -> int:
    params = (module_or_params.parameters() if isinstance(module_or_params, torch.nn.Module)
              else module_or_params)
    return sum(p.numel() for p in params)
