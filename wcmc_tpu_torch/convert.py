"""Carry parameters between flax param trees and the port's modules.

A flax param tree is a nested mapping of numpy arrays (what
``wcmc_tpu``'s checkpoints hold under ``state_dict_<model>``).  The
port's modules are named like that tree, so the mapping is by path:

* a conv's ``kernel`` (K, K, Cin, Cout) HWIO becomes the ``weight``
  (Cout, Cin, K, K) OIHW of the ``nn.Conv2d`` at the same path, and its
  ``bias`` stays as it is;
* every other array (PathNet's flat ``embedding_w*``/``final_w*`` (ci, co)
  matrices and their biases) is copied as it is.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def _flax_path(torch_name: str) -> tuple:
    parts = torch_name.split(".")
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return tuple(parts)


def _to_flax_layout(arr: np.ndarray) -> np.ndarray:
    return arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _tree(module: torch.nn.Module, value) -> dict:
    tree: dict = {}
    for name, p in module.named_parameters():
        path = _flax_path(name)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = _to_flax_layout(value(p).detach().float().cpu().numpy())
    return tree


def to_flax(module: torch.nn.Module) -> dict:
    """The module's parameters as a flax-layout nested dict of f32 numpy
    arrays."""
    return _tree(module, lambda p: p)


def grads_to_flax(module: torch.nn.Module) -> dict:
    """The module's gradients (``.grad``; zeros where there is none) in
    the same flax layout as :func:`to_flax`, so they compare tree to
    tree with ``jax.grad`` of the reference's params."""
    return _tree(module, lambda p: torch.zeros_like(p) if p.grad is None else p.grad)


def load_flax_params(module: torch.nn.Module, tree: Mapping):
    """Copy a flax param tree into ``module`` in place.  Raises
    ``ValueError`` when the tree's paths or shapes do not match the
    module."""
    params = {_flax_path(n): p for n, p in module.named_parameters()}
    given = {path: np.asarray(v) for path, v in _flatten(tree)}
    if set(given) != set(params):
        missing = sorted("/".join(p) for p in set(params) - set(given))
        extra = sorted("/".join(p) for p in set(given) - set(params))
        raise ValueError(f"param tree does not match {type(module).__name__}: "
                         f"missing {missing}, unexpected {extra}")
    with torch.no_grad():
        for path, p in params.items():
            arr = given[path]
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{'/'.join(path)}: shape {arr.shape} != "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))
    return module
