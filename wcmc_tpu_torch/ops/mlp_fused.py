"""Row-wise MLP helpers shared by the PathNet plain versions.

Counterpart of the activation table and the plain chain (``_mlp_xla``)
of ``wcmc_tpu/ops/mlp_fused.py``.  The fused LBMC MLP kernel (K10) comes
with the LBMC port.
"""

from __future__ import annotations

import torch


def _act(name: str, z):
    if name == "relu":
        return torch.clamp(z, min=0.0)
    if name == "leaky_relu":
        return torch.where(z >= 0, z, 0.01 * z)
    if name == "linear":
        return z
    raise ValueError(f"unsupported activation {name!r}")


def matmul_f32(h, w):
    """``h @ w`` of values in ``h``'s dtype, accumulated in float32 —
    the reference's ``jnp.dot(h, w.astype(h.dtype),
    preferred_element_type=float32)``.  bf16 values convert to f32
    exactly, so this is a bf16 product with f32 accumulation."""
    return h.float() @ w.to(h.dtype).float()


def _mlp_plain(x, ws, bs, acts):
    """Plain chain: every layer accumulates in f32, adds its f32 bias,
    applies its activation and rounds to ``x``'s dtype."""
    h = x
    for w, b, a in zip(ws, bs, acts):
        h = _act(a, matmul_f32(h, w) + b.float()).to(x.dtype)
    return h
