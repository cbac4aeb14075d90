"""The opt-in fused KPCN inference (``WCMC_FUSED_INFERENCE=1``) against
wcmc_tpu's, through ``KPCNInterface.validate_batch`` on the same
converted weights and batch (KPCN k5 with the dual PathNet, 2 tiles of 48
px at 2 spp).

* f32: within 1e-4 of max |ref| (the same f32 math summed in another
  order through ~25 stacked convolutions, as ``test_torch_inference.py``
  holds the unfused path); wcmc_tpu's fused convolutions run its own plain
  path, ``_conv_xla``, on the CPU.
* bf16: wcmc_tpu with its Pallas kernels (the fused convolution K6, K1,
  K4-fwd and K5-fwd) in interpret mode, within 1e-2 of max |ref|, as
  ``test_torch_inference.py::test_validate_batch_bf16`` holds the
  unfused path (a bf16 value summed in another order can round to a
  neighbouring one, and the flip travels through the chain).
* The switch changes only the route: the same batch with it off gives
  the unfused path's output (f32, 1e-4 of max), no fused convolution
  runs, and training never takes the fused route.
* LBMC and SBMC have no fused route: the switch leaves their models and
  outputs as they are.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wcmc_tpu.data.batches import synthetic_batch
from wcmc_tpu.train.factory import TrainConfig as JConfig
from wcmc_tpu.train.factory import init_interfaces as jinit
from wcmc_tpu_torch import convert
from wcmc_tpu_torch.data.batches import synthetic_batch as tsynthetic_batch
from wcmc_tpu_torch.ops import _build
from wcmc_tpu_torch.train.factory import TrainConfig as TConfig
from wcmc_tpu_torch.train.factory import init_interfaces as tinit

jmf = importlib.import_module("wcmc_tpu.ops.mlp_fused")
jpk = importlib.import_module("wcmc_tpu.ops.pallas_kernels")

TOLS = {"float32": 1e-4, "bfloat16": 1e-2}
CFG = dict(base_model="kpcn", kpcn_ksize=5, use_llpm_buf=True)


def _close(got, want, tol):
    got = np.asarray(torch.as_tensor(got).float(), np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape
    err = np.max(np.abs(got - want))
    assert err <= tol * np.max(np.abs(want)), err


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {k: np.array(v) for k, v in synthetic_batch(
        rng, "kpcn", batch_size=2, patch=48, spp=2, use_llpm_buf=True).items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_validate_batch_against_jax(monkeypatch, dtype):
    """wcmc_tpu reads the switch when it builds its validation step, so
    its interface is made with the switch set."""
    monkeypatch.setenv("WCMC_FUSED_INFERENCE", "1")
    cfg = dict(CFG, compute_dtype=dtype)
    jif = jinit(JConfig(**cfg))[0]
    tif = tinit(TConfig(**cfg, seed=1), device="cpu")[0]
    for name, state in jif.states.items():
        convert.load_flax_params(tif.models[name], state.params)
    batch = _batch(6)
    jif.to_eval_mode()
    tif.to_eval_mode()
    tif.preprocess(batch)
    interpret = dtype == "bfloat16"
    jpk.INTERPRET, jmf.FORCE_PALLAS = interpret, interpret
    try:
        jrad, jp = jif.validate_batch({k: jnp.asarray(v) for k, v in batch.items()})
    finally:
        jpk.INTERPRET, jmf.FORCE_PALLAS = False, False
    _build.reset_counts()
    trad, tp = tif.validate_batch(batch)
    # two chains of 9 layers, each layer one fused convolution
    assert _build.plain_calls["conv5"] == 18
    _close(trad, jrad, TOLS[dtype])
    for k in jp:
        _close(tp[k], jp[k], TOLS[dtype])


def test_switch_changes_only_the_route(monkeypatch):
    tif = tinit(TConfig(**CFG, compute_dtype="float32", seed=2), device="cpu")[0]
    tif.to_eval_mode()
    batch = _batch(7)
    monkeypatch.delenv("WCMC_FUSED_INFERENCE", raising=False)
    _build.reset_counts()
    rad_off, p_off = tif.validate_batch(batch)
    assert "conv5" not in _build.plain_calls
    assert tif._val_model("dncnn") is tif.models["dncnn"]

    monkeypatch.setenv("WCMC_FUSED_INFERENCE", "1")
    fused = tif._val_model("dncnn")
    model = tif.models["dncnn"]
    assert fused is not model and fused.fused and not model.fused
    # the fused variant shares the parameters: no copy of the weights
    assert [p.data_ptr() for p in fused.parameters()] == \
        [p.data_ptr() for p in model.parameters()]
    _build.reset_counts()
    rad_on, p_on = tif.validate_batch(batch)
    assert _build.plain_calls["conv5"] == 18
    _close(rad_on, rad_off, TOLS["float32"])
    for k in p_off:
        torch.testing.assert_close(p_on[k], p_off[k], rtol=0, atol=0)

    # training never takes the fused route, switch or not
    trainer = tinit(TConfig(**CFG, compute_dtype="float32", manif_learn=True,
                            manif_loss="FMSE", seed=2), device="cpu")[0]
    tb = tsynthetic_batch(np.random.default_rng(8), "kpcn", 1, 48, 2, True)
    trainer.to_train_mode()
    trainer.preprocess(tb)
    _build.reset_counts()
    trainer.train_batch(tb)
    assert "conv5" not in _build.plain_calls


@pytest.mark.parametrize("base", ["lbmc", "sbmc"])
def test_sample_space_models_ignore_the_switch(monkeypatch, base):
    tif = tinit(TConfig(base_model=base, sbmc_ksize=5, use_llpm_buf=True,
                        compute_dtype="float32"), device="cpu")[0]
    tif.to_eval_mode()
    batch = tsynthetic_batch(np.random.default_rng(9), base, 1, 16, 2, True)
    monkeypatch.delenv("WCMC_FUSED_INFERENCE", raising=False)
    rad_off, p_off = tif.validate_batch(batch)
    monkeypatch.setenv("WCMC_FUSED_INFERENCE", "1")
    assert not hasattr(tif.models["dncnn"], "fused")
    assert tif._val_model("dncnn") is tif.models["dncnn"]
    _build.reset_counts()
    rad_on, p_on = tif.validate_batch(batch)
    assert "conv5" not in _build.plain_calls
    torch.testing.assert_close(rad_on, rad_off, rtol=0, atol=0)
    torch.testing.assert_close(p_on, p_off, rtol=0, atol=0)
