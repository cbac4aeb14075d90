"""Split TF32 ("3xTF32") on the CPU: what ``csrc/tf32x3.cuh`` does on the
card, for packing the weights the tensor-core f32 bodies read and for the
plain walks of their arithmetic in the tests.

An f32 value ``a`` is split into ``hi = tf32(a)`` and ``lo = tf32(a - hi)``,
each rounded to nearest with ties away from zero on the bits (PTX's
``cvt.rna.tf32.f32``: 10 explicit mantissa bits, the low 13 bits of the f32
pattern zero); a product is ``lo . hi + hi . lo + hi . hi``, added in that
order.  The products of two tf32 values are exact in f32.
"""

from __future__ import annotations

import torch


def tf32_round(t):
    """``t`` (f32) rounded to tf32, nearest, ties away from zero."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(t):
    """``(hi, lo)`` of f32 ``t``: ``hi = tf32(t)``, ``lo = tf32(t - hi)``."""
    hi = tf32_round(t)
    return hi, tf32_round(t.float() - hi)


def mm_tf32x3(acc, a, b):
    """``acc`` + ``a @ b`` in split TF32 as the kernels take a k8 step: the
    three products in their order (lo . hi, hi . lo, hi . hi), summed from
    zero and then added to the f32 ``acc``; ``a`` and ``b`` split here."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    part = al @ bh
    part = part + ah @ bl
    return acc + (part + ah @ bh)


def mm_k8(acc, a, b):
    """``acc`` + ``a @ b`` in split TF32, k8 step by k8 step (the kernel's
    order over K), each step's partial from zero added to ``acc``
    (``mm_tf32x3``)."""
    for k0 in range(0, a.shape[-1], 8):
        acc = mm_tf32x3(acc, a[..., k0:k0 + 8], b[k0:k0 + 8])
    return acc


def pack_b_tf32(w):
    """A (K, N) matrix, K and N multiples of 8, as the B operand of
    mma.m16n8k8 in split TF32: ``(N / 8, K / 8, 32, 4)`` = [n8 tile][k8
    step][lane][hi(b0), hi(b1), lo(b0), lo(b1)], with lane = 4 g + t, b0 =
    w[8 k + 2t][8 n + g] and b1 = w[8 k + 2t + 1][8 n + g] (k t and k t + 4
    of the fragment hold channels 2t and 2t + 1, as the kernels' A
    fragments of row-major tiles do)."""
    k, n = w.shape
    hi, lo = split_tf32(w.float().reshape(k // 8, 4, 2, n // 8, 8))   # ks, t, e, jn, g
    return torch.stack([hi, lo]).permute(4, 1, 5, 2, 0, 3).reshape(n // 8, k // 8, 32, 4)
