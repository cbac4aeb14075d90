"""Losses used by the ported paths.

Counterpart of ``wcmc_tpu/losses.py``; so far only the test metric
``relative_mse`` (the KPCN interface's ``l_test``).  The training and
manifold losses come with the training port.
"""

from __future__ import annotations

import torch


def relative_mse(im: torch.Tensor, ref: torch.Tensor, eps: float = 1e-2):
    """0.5 * mean((x - y)^2 / (y^2 + eps))."""
    return 0.5 * torch.mean((im - ref) ** 2 / (ref**2 + eps))
