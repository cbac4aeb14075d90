"""Checkpoint writing and reading, in ``wcmc_tpu``'s file format.

A checkpoint is a pickle (protocol 4) of host numpy trees: the
``format_version`` (2), ``description``, ``start_epoch``, ``model``,
``best_err`` and ``args`` of the run, and per model ``state_dict_<m>``
(its flax param tree: ``convert.to_flax``) and ``optim_<m>`` (its optax
optimizer state).  The file is written to ``<path>.tmp`` and moved into
place, so a reader never sees half a file.

The optimizer state is that of ``optax.flatten(optax.chain(clip |
clip_by_global_norm, inject_hyperparams(adam), [scale_by_schedule]))``
(``wcmc_tpu/train/state.py``), a tuple of optax named tuples:

    (EmptyState(),
     InjectStatefulHyperparamsState(count, {learning_rate, b1, b2, eps,
         eps_root}, {}, (ScaleByAdamState(count, mu, nu), EmptyState())),
     [ScaleByScheduleState(count)])          # with a warmup

``mu`` and ``nu`` are each one flat f32 vector: every parameter in flax
layout, raveled, in the leaf order of the flax tree (sorted keys).  The
port's :class:`~wcmc_tpu_torch.train.state.AdamWithClip` keeps torch
Adam's per-parameter ``exp_avg`` / ``exp_avg_sq`` / ``step`` in torch
layouts, its warmup ``count`` and ``lr``; this module maps one to the
other both ways.

The port does not import optax.  Reading, every class of the
``jax``/``jaxlib``/``flax``/``optax`` modules becomes an inert stand-in
that keeps what the pickle hands it; writing, the stand-ins pickle as
the same global references (module and class name), so JAX reads the
port's files as optax's own classes.
"""

from __future__ import annotations

import copyreg
import io
import os
import pickle
from typing import Any

import numpy as np
import torch

from wcmc_tpu_torch.convert import _flax_path, _to_flax_layout, load_flax_params, to_flax

FORMAT_VERSION = 2

_JAX_MODULES = ("jax", "jaxlib", "flax", "optax")

# optax's classes of the optimizer state, by (module, class) as its
# pickles name them
_EMPTY = ("optax._src.base", "EmptyState")
_INJECT = ("optax.schedules._inject", "InjectStatefulHyperparamsState")
_ADAM = ("optax._src.transform", "ScaleByAdamState")
_SCHEDULE = ("optax._src.transform", "ScaleByScheduleState")

# adam's hyperparameters besides the learning rate (optax's defaults,
# which both packages use)
_ADAM_HYPER = {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "eps_root": 0.0}


class _Standin:
    """Inert stand-in for a class of the JAX stack: keeps whatever the
    pickle hands it (constructor args and state), and pickles back as
    the same global reference with the same args."""

    def __new__(cls, *args, **kwargs):
        obj = super().__new__(cls)
        obj.args, obj.kwargs = args, kwargs
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.state = state

    def __reduce_ex__(self, protocol):
        state = getattr(self, "state", None)
        return copyreg.__newobj__, (type(self),) + tuple(self.args), state

    def __repr__(self):
        return f"{type(self).__name__}{self.args!r}"


class _FrozenDictStandin(dict):
    """flax's FrozenDict pickles as ``FrozenDict(dict)``; read it as a
    dict."""


_CLASSES: dict = {}


def standin(module: str, name: str) -> type:
    """The stand-in class for ``module.name`` (one class per name)."""
    key = (module, name)
    if key not in _CLASSES:
        _CLASSES[key] = type(name, (_Standin,), {"__module__": module, "__qualname__": name})
    return _CLASSES[key]


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in _JAX_MODULES:
            if name == "FrozenDict":
                return _FrozenDictStandin
            return standin(module, name)
        return super().find_class(module, name)


class _Pickler(pickle._Pickler):
    """The pure-Python pickler, with the stand-in classes written as the
    global references they stand for (the C pickler insists on importing
    a class it writes by name)."""

    def save_global(self, obj, name=None):
        if isinstance(obj, type) and issubclass(obj, _Standin):
            self.save(obj.__module__)
            self.save(obj.__qualname__)
            self.write(pickle.STACK_GLOBAL)
            self.memoize(obj)
            return
        super().save_global(obj, name)

    dispatch = dict(pickle._Pickler.dispatch)
    dispatch[type] = save_global


def load_checkpoint(path: str) -> dict:
    """Read a checkpoint written by either package.  Unpickling runs code
    named by the file: read only checkpoints this project wrote."""
    with open(path, "rb") as f:
        return _Unpickler(f).load()


def _flat_params(module: torch.nn.Module):
    """The module's parameters in the leaf order of its flax tree (sorted
    paths), each with its flax path."""
    return sorted(((_flax_path(n), p) for n, p in module.named_parameters()),
                  key=lambda t: t[0])


def _ravel(module, tensors) -> np.ndarray:
    """One flat f32 vector of ``tensors`` (a dict parameter -> tensor of
    its shape) in flax layout and flax leaf order."""
    parts = [_to_flax_layout(tensors[p].detach().float().cpu().numpy()).ravel()
             for _, p in _flat_params(module)]
    return np.concatenate(parts) if parts else np.zeros(0, np.float32)


def _unravel(module, flat: np.ndarray, name: str) -> dict:
    """The inverse of ``_ravel``: parameter -> f32 tensor in torch layout
    on the parameter's device."""
    flat = np.asarray(flat, np.float32)
    params = _flat_params(module)
    n = sum(p.numel() for _, p in params)
    if flat.shape != (n,):
        raise ValueError(f"optimizer state for {name!r} holds {flat.shape} values, the "
                         f"model {n}")
    out, pos = {}, 0
    for _, p in params:
        shape = tuple(p.shape)
        flax_shape = (shape[2], shape[3], shape[1], shape[0]) if len(shape) == 4 else shape
        chunk = flat[pos:pos + p.numel()].reshape(flax_shape)
        if len(shape) == 4:
            chunk = chunk.transpose(3, 2, 0, 1)
        out[p] = torch.from_numpy(np.ascontiguousarray(chunk)).to(p.device)
        pos += p.numel()
    return out


def _i32(v) -> np.ndarray:
    return np.asarray(v, np.int32)


def _f32(v) -> np.ndarray:
    return np.asarray(v, np.float32)


def optim_state(module: torch.nn.Module, opt) -> tuple:
    """``opt`` (an ``AdamWithClip`` over ``module``'s parameters) as the
    reference's flattened optax state of stand-ins."""
    params = [p for _, p in _flat_params(module)]
    state = opt.adam.state
    steps = {int(state[p]["step"]) for p in params if p in state}
    if len(steps) > 1:
        raise ValueError(f"parameters at different Adam steps: {sorted(steps)}")
    step = steps.pop() if steps else 0

    def moment(key):
        return _ravel(module, {p: state[p][key] if p in state else torch.zeros_like(p)
                               for p in params})

    adam = standin(*_ADAM)(_i32(step), moment("exp_avg"), moment("exp_avg_sq"))
    hyper = {"learning_rate": _f32(opt.lr), **{k: _f32(v) for k, v in _ADAM_HYPER.items()}}
    chain = [standin(*_EMPTY)(),
             standin(*_INJECT)(_i32(step), hyper, {}, (adam, standin(*_EMPTY)()))]
    if opt.warmup_steps:
        chain.append(standin(*_SCHEDULE)(_i32(opt.count)))
    return tuple(chain)


def load_optim_state(module: torch.nn.Module, opt, host, name: str = "model"):
    """Load the reference's optimizer state ``host`` (as ``load_checkpoint``
    reads it) into ``opt`` in place: Adam's moments and step count per
    parameter, the learning rate and the warmup count."""
    try:
        inject = next(s for s in host if type(s).__name__ == _INJECT[1])
        count, hyper, _, inner = inject.args
        adam = next(s for s in inner if type(s).__name__ == _ADAM[1])
        adam_count, mu, nu = adam.args
    except (StopIteration, ValueError, AttributeError, TypeError) as e:
        raise ValueError(f"optimizer state for {name!r} is not the flattened optax chain of "
                         f"checkpoint format {FORMAT_VERSION}") from e
    schedule = [s for s in host if type(s).__name__ == _SCHEDULE[1]]
    if bool(schedule) != bool(opt.warmup_steps):
        raise ValueError(f"optimizer state for {name!r}: warmup "
                         f"{'present' if schedule else 'absent'} in the checkpoint, "
                         f"warmup_steps={opt.warmup_steps} in this build")
    exp_avg, exp_avg_sq = _unravel(module, mu, name), _unravel(module, nu, name)
    step = int(adam_count)
    opt.adam.state.clear()
    if step > 0:
        for p in exp_avg:
            opt.adam.state[p] = {"step": torch.tensor(float(step)), "exp_avg": exp_avg[p],
                                 "exp_avg_sq": exp_avg_sq[p]}
    opt.lr = float(np.asarray(hyper["learning_rate"]))
    opt.count = int(schedule[0].args[0]) if schedule else int(count)


def save_checkpoint(path: str, interface, epoch: int, args: Any = None,
                    description: str = "", extra: dict | None = None):
    """Write ``interface``'s models and optimizers as a checkpoint of the
    reference's format 2 (see the module docstring)."""
    state_dict = {
        "format_version": FORMAT_VERSION,
        "description": description,
        "start_epoch": epoch + 1,
        "model": str(interface),
        "best_err": interface.best_err,
        "args": args,
    }
    for name, (module, opt) in interface.state_dicts().items():
        state_dict["state_dict_" + name] = to_flax(module)
        state_dict["optim_" + name] = optim_state(module, opt)
    if extra:
        state_dict.update(extra)
    buf = io.BytesIO()
    _Pickler(buf, protocol=4).dump(state_dict)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getbuffer())
    os.replace(tmp, path)


def restore_interface(interface, ck: dict, load_optim: bool = True,
                      lr_override: dict | None = None):
    """Load a checkpoint into the interface's models (on their device)
    and, with ``load_optim``, its optimizers, in place.  ``lr_override``
    ({model name: lr}) replaces the checkpoint's learning rate (the fresh
    learning rate of a resume without ``--lr_ckpt``).  Raises
    ``ValueError`` when a model's parameters or optimizer state are
    missing or do not match."""
    for name, module in interface.models.items():
        key = "state_dict_" + name
        if key not in ck:
            raise ValueError(f"checkpoint has no parameters for {name!r}")
        load_flax_params(module, ck[key])
        opt = interface.optims.get("optim_" + name)
        if opt is None:
            continue
        if load_optim and "optim_" + name in ck:
            load_optim_state(module, opt, ck["optim_" + name], name)
        if lr_override and name in lr_override:
            opt.lr = float(lr_override[name])
    interface.best_err = ck.get("best_err", interface.best_err)
    return interface
