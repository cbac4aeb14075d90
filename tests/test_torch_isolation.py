"""The port stands alone: no module of wcmc_tpu_torch, and not
chip_smoke.py, imports JAX, flax, optax or wcmc_tpu, while serving a
batch and taking a train step of KPCN and of LBMC; and its entry points
refuse to fall back to the CPU silently."""

import os
import subprocess
import sys
import textwrap

import jax  # noqa: F401  (tests of the port import both frameworks)
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = textwrap.dedent("""
    import importlib, importlib.util, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "wcmc_tpu")

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("refused import of " + name)
            return None

    sys.meta_path.insert(0, Refuse())

    import numpy as np
    import torch
    import wcmc_tpu_torch

    names = [m.name for m in pkgutil.walk_packages(wcmc_tpu_torch.__path__,
                                                   "wcmc_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))

    from wcmc_tpu_torch.train.factory import TrainConfig, init_interfaces
    cfg = TrainConfig(kpcn_ksize=5, use_llpm_buf=True, compute_dtype="float32")
    iface = init_interfaces(cfg, device="cpu")[0]
    rng = np.random.default_rng(0)
    p = 48
    batch = {k: rng.random((1, p, p, c), dtype=np.float32) for k, c in (
        ("target_total", 3), ("target_diffuse", 3), ("target_specular", 3),
        ("kpcn_diffuse_in", 35), ("kpcn_specular_in", 35),
        ("kpcn_diffuse_buffer", 3), ("kpcn_specular_buffer", 3),
        ("kpcn_albedo", 3))}
    batch["paths"] = rng.random((1, 2, p, p, 36), dtype=np.float32)
    rad, pb = iface.validate_batch(batch)
    assert rad.shape == (1, 8, 8, 3) and bool(torch.isfinite(rad).all())
    assert pb["diffuse"].shape == (1, 2, p, p, 3)

    from wcmc_tpu_torch.data.batches import synthetic_batch
    cfg = TrainConfig(kpcn_ksize=5, use_llpm_buf=True, manif_learn=True,
                      manif_loss="FMSE", compute_dtype="float32", finite_check_every=1)
    trainer = init_interfaces(cfg, device="cpu")[0]
    tbatch = synthetic_batch(rng, "kpcn", batch_size=1, patch=48, spp=2, use_llpm_buf=True)
    trainer.to_train_mode()
    trainer.preprocess(tbatch)
    losses = trainer.train_batch(tbatch)
    assert {"l_diffuse", "l_manif_diffuse", "l_total"} <= set(losses)
    assert all(bool(torch.isfinite(v)) for v in losses.values())

    from wcmc_tpu_torch.models.lbmc import LayerNet  # noqa: F401
    from wcmc_tpu_torch.ops.mlp_fused import fused_mlp  # noqa: F401
    cfg = TrainConfig(base_model="lbmc", use_llpm_buf=True, manif_learn=True,
                      manif_loss="FMSE", compute_dtype="float32", finite_check_every=1)
    lbmc = init_interfaces(cfg, device="cpu")[0]
    lb = synthetic_batch(rng, "lbmc", batch_size=1, patch=16, spp=2, use_llpm_buf=True)
    lbmc.to_train_mode()
    lbmc.preprocess(lb)
    losses = lbmc.train_batch(lb)
    assert {"l_manif", "l_recon", "l_total"} <= set(losses)
    assert all(bool(torch.isfinite(v)) for v in losses.values())
    rad, pb = lbmc.validate_batch(lb)
    assert rad.shape == (1, 16, 16, 3) and pb.shape == (1, 2, 16, 16, 3)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print("OK", len(names))
""")


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[-1])
    assert n_modules >= 22


def test_entry_points_need_a_card_or_an_explicit_device(tmp_path, monkeypatch):
    from wcmc_tpu_torch import test_models
    from wcmc_tpu_torch.data.dataset import offline_preprocess
    from wcmc_tpu_torch.train.factory import TrainConfig, init_interfaces
    from wcmc_tpu_torch.utils.utils import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_interfaces(TrainConfig(kpcn_ksize=5))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        offline_preprocess(str(tmp_path), mode="test")
    args = test_models.parse_args(["--model_name", "KPCN_x",
                                   "--data_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_models.main(args)
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_refuses_without_a_card():
    """chip_smoke.py exits non-zero and prints no result without CUDA
    (skips where torch sees a card)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; chip_smoke.py would run for real")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
