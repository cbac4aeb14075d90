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
