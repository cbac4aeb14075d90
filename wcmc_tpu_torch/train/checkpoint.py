"""Checkpoint reading.

``wcmc_tpu`` checkpoints are pickles of host numpy trees:
``state_dict_<model>`` flax param trees, ``optim_<model>`` optimizer
states, ``start_epoch``, ``best_err`` and the run args.  The optimizer
states are optax objects, so unpickling them plainly needs JAX.  The
reader here substitutes an inert stand-in for every class from the
``jax``/``jaxlib``/``flax``/``optax`` modules, so the same file loads on a
machine without JAX; the parameters are plain numpy arrays in dicts and
come through unchanged.
"""

from __future__ import annotations

import pickle

from wcmc_tpu_torch.convert import load_flax_params

_JAX_MODULES = ("jax", "jaxlib", "flax", "optax")


class _Standin:
    """Inert stand-in for a class of the JAX stack: keeps whatever the
    pickle hands it (constructor args and state)."""

    def __new__(cls, *args, **kwargs):
        obj = super().__new__(cls)
        obj.args, obj.kwargs = args, kwargs
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.state = state


class _FrozenDictStandin(dict):
    """flax's FrozenDict pickles as ``FrozenDict(dict)``; read it as a
    dict."""


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in _JAX_MODULES:
            if name == "FrozenDict":
                return _FrozenDictStandin
            return type(name, (_Standin,), {"__module__": module})
        return super().find_class(module, name)


def load_checkpoint(path: str) -> dict:
    """Read a checkpoint written by ``wcmc_tpu.train.checkpoint``.
    Unpickling runs code named by the file: read only checkpoints this
    project wrote."""
    with open(path, "rb") as f:
        return _Unpickler(f).load()


def restore_interface(interface, ck: dict):
    """Load the checkpoint's parameters into the interface's models in
    place (on their device).  Raises ``ValueError`` when a model's
    parameters are missing or do not match."""
    for name, module in interface.models.items():
        key = "state_dict_" + name
        if key not in ck:
            raise ValueError(f"checkpoint has no parameters for {name!r}")
        load_flax_params(module, ck[key])
    interface.best_err = ck.get("best_err", interface.best_err)
    return interface
