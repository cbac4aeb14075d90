"""The multi-device dry run, and the rank-side tasks it is made of.

Counterpart of the repository's ``__graft_entry__.py dryrun_multichip``:
every parallel mode over ``n`` gloo ranks on the CPU at tiny shapes,

1. the full KPCN + FMSE data-parallel train step (batch sharded,
   parameters replicated, gradients averaged; the replicas must agree
   bit for bit);
2. row-sharded KPCN inference with the halo exchange, against the
   unsharded forward's interior;
3. an spp-sharded PathNet forward, against the unsharded one.

    python -m wcmc_tpu_torch.parallel.dryrun [n]

The tasks (``dp_step``, ``halo_forward``, ``sample_forward``) run on
every rank of a ``launch.RankPool`` and take and return numpy: the
tests and ``chip_smoke.py`` drive the same tasks at their own shapes and
devices.  Each builds the models from a ``TrainConfig``'s fields or a
model spec, loads the given flax-layout parameters (``convert``), and
returns what it launched (``ops._build`` counts, reset at its start).
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

import numpy as np
import torch


def _counts():
    from wcmc_tpu_torch.ops import _build

    return {"launches": dict(_build.launches), "plain_calls": dict(_build.plain_calls)}


def _reset_counts():
    from wcmc_tpu_torch.ops import _build

    _build.reset_counts()


def _interface(cfg: dict, params: Optional[dict], device):
    from wcmc_tpu_torch import convert
    from wcmc_tpu_torch.train.factory import TrainConfig, init_interfaces

    iface = init_interfaces(TrainConfig(**cfg), device=device)[0]
    for name, tree in (params or {}).items():
        convert.load_flax_params(iface.models[name], tree)
    return iface


def resolve_batch(batch):
    """A batch, or the recipe of one that each rank builds itself instead
    of receiving it pickled: ``("synthetic", family, seed, batch_size,
    patch, spp, use_llpm_buf)``, ``data.batches.synthetic_batch`` from
    ``numpy.random.default_rng(seed)``."""
    if isinstance(batch, dict):
        return batch
    from wcmc_tpu_torch.data.batches import synthetic_batch

    kind, family, seed, *args = batch
    if kind != "synthetic":
        raise ValueError(f"unknown batch recipe {kind!r}")
    return synthetic_batch(np.random.default_rng(seed), family, *args)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _flat_grads(models):
    return {n: torch.cat([p.grad.reshape(-1).double().cpu() if p.grad is not None
                          else torch.zeros(p.numel(), dtype=torch.float64)
                          for p in m.parameters()]).numpy()
            for n, m in models.items()}


def dp_step(cfg: dict, batch: dict, params: Optional[dict] = None, draws=None, steps: int = 1,
            devices: Optional[Sequence] = None, validate: bool = False,
            grads: bool = False) -> dict:
    """On every rank: the interface of ``cfg`` (``params`` loaded) made
    data parallel over all ranks, ``steps`` train steps on this rank's
    shard of the global ``batch`` (``draws`` injected into each), then
    with ``validate`` one validation batch.  Returns the loss dicts and
    each step's wall ms, every replica's parameter checksum, with
    ``grads`` the first step's averaged gradients (flattened per model,
    before the optimizer; a forward and backward more), and on rank 0
    the parameters after the steps (flax layout) and the validation's
    radiance and ``m_val``.
    ``batch`` may be a recipe (``resolve_batch``)."""
    import time

    from wcmc_tpu_torch import convert
    from wcmc_tpu_torch.parallel.mesh import checksum, make_mesh, shard_batch

    mesh = make_mesh(devices=devices)
    batch = shard_batch(resolve_batch(batch), mesh)
    iface = _interface(cfg, params, mesh.device).to_mesh(mesh)
    iface.to_train_mode()
    out = {"losses": [], "step_ms": []}
    _reset_counts()
    for i in range(steps):
        iface.preprocess(batch)
        if grads and i == 0:
            loss = iface.train_batch(batch, grad_hook_mode=True, draws=draws)
            out["grads"] = _flat_grads(iface.models)
        _sync(mesh.device)
        t0 = time.perf_counter()
        loss = iface.train_batch(batch, draws=draws)
        _sync(mesh.device)
        out["step_ms"].append(1e3 * (time.perf_counter() - t0))
        out["losses"].append({k: float(v) for k, v in loss.items()})
    out.update(_counts())
    out["checksum"] = checksum(iface.models)
    if validate:
        iface.to_eval_mode()
        radiance, _ = iface.validate_batch(batch)
        out["radiance"] = radiance.float().cpu().numpy()
        out["m_val"] = float(iface.m_losses["m_val"])
    if mesh.rank == 0:
        out["params"] = {n: convert.to_flax(m) for n, m in iface.models.items()}
    return out


def halo_forward(cfg: dict, frame: dict, halo: int, params: Optional[dict] = None,
                 devices: Optional[Sequence] = None) -> dict:
    """On every rank of a 1 x n mesh: the dncnn of ``cfg`` run row-sharded
    on its band of the global ``frame`` (the KPCN keys) with ``halo``
    rows exchanged.  Returns this rank's band of the radiance."""
    from wcmc_tpu_torch.parallel.halo import KPCN_KEYS, kpcn_spatial_inference, shard_rows
    from wcmc_tpu_torch.parallel.mesh import make_mesh

    world = torch.distributed.get_world_size()
    mesh = make_mesh(n_data=1, n_spatial=world, devices=devices)
    model = _interface(cfg, params, mesh.device).models["dncnn"]
    band = shard_rows({k: frame[k] for k in KPCN_KEYS}, mesh)
    _reset_counts()
    out = kpcn_spatial_inference(model, mesh, halo)(band)
    return {"band": out.float().cpu().numpy(), **_counts()}


def build_model(spec: dict, params: dict, device):
    """A model from ``spec`` (``{"kind": "pathnet" | "dual_pathnet" |
    "layernet" | "multisteps", "dtype": "bfloat16" | None, **its
    constructor's arguments}``) with ``params`` (a flax tree; for the dual
    PathNet ``{"diffuse": ..., "specular": ...}``) loaded, on ``device``."""
    from wcmc_tpu_torch import convert
    from wcmc_tpu_torch.models import LayerNet, Multisteps, PathNet

    kw = dict(spec)
    kind = kw.pop("kind")
    kw["dtype"] = {"bfloat16": torch.bfloat16, None: None}[kw.get("dtype")]
    ctor = {"pathnet": PathNet, "dual_pathnet": PathNet, "layernet": LayerNet,
            "multisteps": Multisteps}[kind]
    if kind == "dual_pathnet":
        return {name: convert.load_flax_params(ctor(**kw), tree).to(device).eval()
                for name, tree in params.items()}
    return convert.load_flax_params(ctor(**kw), params).to(device).eval()


def sample_forward(spec: dict, params: dict, batch: dict,
                   devices: Optional[Sequence] = None) -> dict:
    """On every rank of a 1 x n mesh: the forward of the model of ``spec``
    with the spp axis of the global ``batch`` sharded.  Returns the output
    (PathNet's: this rank's samples; the dual PathNet's: both branches'
    and the moments of this rank's samples)."""
    from wcmc_tpu_torch.models.pathnet import dual_pathnet_apply
    from wcmc_tpu_torch.parallel.mesh import make_mesh
    from wcmc_tpu_torch.parallel.sample import (
        make_sample_parallel, shard_samples, with_sample_group,
    )

    world = torch.distributed.get_world_size()
    mesh = make_mesh(n_data=1, n_spatial=world, devices=devices)
    model = build_model(spec, params, mesh.device)
    _reset_counts()
    if spec["kind"] == "dual_pathnet":
        d, s = (with_sample_group(model[n], mesh.spatial_group) for n in ("diffuse", "specular"))
        local = {k: torch.as_tensor(v).to(mesh.device)
                 for k, v in shard_samples(batch, mesh).items()}
        with torch.no_grad():
            p_d, p_s, (ssum, ssq) = dual_pathnet_apply(d, s, local, with_moments=True)
        out = {"diffuse": p_d, "specular": p_s, "ssum": ssum, "ssq": ssq}
    else:
        out = {"out": make_sample_parallel(model, mesh)(batch)}
    return {**{k: v.float().cpu().numpy() for k, v in out.items()}, **_counts()}


def _synthetic(kind, rng, *args, **kw):
    from wcmc_tpu_torch.data.batches import synthetic_batch

    return {k: v.numpy() for k, v in synthetic_batch(rng, kind, *args, **kw).items()}


def dryrun(n: int, pool=None) -> dict:
    """The three modes over ``n`` gloo ranks on the CPU (tiny shapes), in
    ``pool`` (a ``RankPool`` of ``n`` CPU ranks) or a pool of its own:
    raises if a mode fails or disagrees with its single-process run."""
    import contextlib
    from wcmc_tpu_torch import convert
    from wcmc_tpu_torch.models import PathNet
    from wcmc_tpu_torch.parallel.launch import RankPool

    rng = np.random.default_rng(0)
    cfg = dict(base_model="kpcn", kpcn_ksize=5, use_llpm_buf=True, manif_learn=True,
               manif_loss="FMSE", finite_check_every=1, compute_dtype="float32")
    batch = _synthetic("kpcn", rng, n, 48, 2, True)
    vanilla = dict(base_model="kpcn", kpcn_ksize=5, compute_dtype="float32")
    plain = _synthetic("kpcn", rng, 1, 48, 2)
    frame = {k: np.concatenate([v] * n, axis=1) for k, v in plain.items()
             if k.startswith("kpcn_")}
    pathnet = PathNet(ic=36, outc=3, generator=torch.Generator().manual_seed(0))
    spec = {"kind": "pathnet", "ic": 36, "outc": 3}
    paths = {"paths": rng.standard_normal((1, 2 * n, 16, 16, 36)).astype(np.float32)}
    report = {}
    if pool is not None and pool.world != n:
        raise ValueError(f"the pool has {pool.world} ranks, not {n}")
    own = RankPool(n, "gloo", threads=1) if pool is None else contextlib.nullcontext(pool)
    with own as pool:
        res = pool.run(dp_step, cfg, batch)
        sums = {r["checksum"] for r in res}
        loss = res[0]["losses"][0]
        if len(sums) != 1 or not all(np.isfinite(v) for v in loss.values()):
            raise AssertionError(f"dp({n}): checksums {sums}, losses {loss}")
        report["dp"] = loss
        print(f"dryrun dp({n}): OK — " + ", ".join(f"{k}={v:.4f}" for k, v in loss.items()))

        bands = pool.run(halo_forward, vanilla, frame, 24)
        out = np.concatenate([r["band"] for r in bands], axis=1)
        model = _interface(vanilla, None, "cpu").models["dncnn"]
        with torch.no_grad():
            full = model({k: torch.from_numpy(v) for k, v in frame.items()})["radiance"].numpy()
        r = model.shrink // 2
        err = float(np.abs(out[:, r:-r, r:-r] - full).max())
        if err > 1e-4 * float(np.abs(full).max()):
            raise AssertionError(f"spatial-halo({n}): off the unsharded forward by {err}")
        report["halo_max_err"] = err
        print(f"dryrun spatial-halo({n}): OK — out {out.shape}, max err {err:.2e}")

        parts = pool.run(sample_forward, spec, convert.to_flax(pathnet), paths)
        p_out = np.concatenate([r["out"] for r in parts], axis=1)
        with torch.no_grad():
            ref = pathnet({"paths": torch.from_numpy(paths["paths"])}).numpy()
        err = float(np.abs(p_out - ref).max())
        if err > 1e-5 * float(np.abs(ref).max()):
            raise AssertionError(f"sample-parallel({n}): off the unsharded forward by {err}")
        report["sample_max_err"] = err
        print(f"dryrun sample-parallel({n}): OK — p {p_out.shape}, max err {err:.2e}")
    return report


if __name__ == "__main__":
    dryrun(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
