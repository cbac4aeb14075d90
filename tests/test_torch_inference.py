"""The ported serving path as a whole against wcmc_tpu, in f32 (and one
batch in the serving dtype, bf16):
``KPCNInterface.validate_batch``, tiled ``evaluate.inference`` +
``evaluate_frame`` on a 192x192 4-spp synthetic scene with the dual
PathNet, ``denoise``'s CSVs, and a checkpoint written by wcmc_tpu read
back by the port.

Tolerances: 1e-4 of max |ref| on images (f32, summed in another order
through ~25 stacked convolutions), 1e-4 relative on the metric grid;
1e-2 of max |ref| in bf16."""

import csv
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wcmc_tpu import evaluate as jev
from wcmc_tpu.data.batches import synthetic_batch
from wcmc_tpu.data.dataset import offline_preprocess
from wcmc_tpu.data.full_image import FullImageDataset as JFull
from wcmc_tpu.train.checkpoint import save_checkpoint
from wcmc_tpu.train.factory import TrainConfig as JConfig
from wcmc_tpu.train.factory import init_interfaces as jinit
from wcmc_tpu_torch import convert
from wcmc_tpu_torch import evaluate as tev
from wcmc_tpu_torch import test_models as ttm
from wcmc_tpu_torch.data.full_image import FullImageDataset as TFull
from wcmc_tpu_torch.data.synthetic import build_synthetic_dataset
from wcmc_tpu_torch.train.checkpoint import load_checkpoint, restore_interface
from wcmc_tpu_torch.train.factory import TrainConfig as TConfig
from wcmc_tpu_torch.train.factory import init_interfaces as tinit

TOL = 1e-4
BF16_TOL = 1e-2
CFG = dict(base_model="kpcn", kpcn_ksize=5, use_llpm_buf=True,
           compute_dtype="float32")


def _close(got, want, tol=TOL):
    got = np.asarray(torch.as_tensor(got).float(), np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want))


@pytest.fixture(scope="module")
def ifaces():
    """A wcmc_tpu interface and a port interface with its parameters."""
    jif = jinit(JConfig(**CFG))[0]
    tif = tinit(TConfig(**CFG, seed=1), device="cpu")[0]
    for name, state in jif.states.items():
        convert.load_flax_params(tif.models[name], state.params)
    return jif, tif


@pytest.fixture(scope="module")
def scene_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("serve"))
    build_synthetic_dataset(root, n_train=0, n_val=0, n_test=1, size=192, spp=4,
                            test_extra_parts=0, seed=9)
    offline_preprocess(root, mode="test", spp=4, sbmc=False, test_spps=(4,))
    return root


def test_validate_batch(ifaces):
    jif, tif = ifaces
    rng = np.random.default_rng(0)
    batch = {k: np.array(v) for k, v in synthetic_batch(
        rng, "kpcn", batch_size=2, patch=48, spp=2, use_llpm_buf=True).items()}
    jif.to_eval_mode()
    tif.to_eval_mode()
    tif.preprocess(batch)
    jrad, jp = jif.validate_batch({k: jnp.asarray(v) for k, v in batch.items()})
    trad, tp = tif.validate_batch(batch)
    _close(trad, jrad)
    assert set(tp) == set(jp) == {"diffuse", "specular"}
    for k in jp:
        _close(tp[k], jp[k])
    np.testing.assert_allclose(float(tif.m_losses["m_val"]),
                               float(jif.m_losses["m_val"]), rtol=TOL)


def test_inference_and_metrics(ifaces, scene_root):
    jif, tif = ifaces
    fn = os.path.join(scene_root, "test", "input", "scene0.npy")
    jds = JFull(fn, 4, "kpcn", use_llpm_buf=True)
    tds = TFull(fn, 4, "kpcn", use_llpm_buf=True)
    assert len(tds) == len(jds) == 4 and tds.coords == jds.coords
    jout, jpath, _ = jev.inference(jif, jds, batch_size=4)
    tout, tpath, _ = tev.inference(tif, tds, batch_size=3)   # a ragged batch too
    _close(tout, jout)
    for k in jpath:
        _close(tpath[k], jpath[k])
    oh, ow = tds.orig_h, tds.orig_w
    args = (tds.full_tgt[:oh, :ow], tds.full_ipt[:oh, :ow], tds.has_hit[:oh, :ow])
    jres, jres_in = jev.evaluate_frame(jout, *args)
    tres, tres_in = tev.evaluate_frame(tout, *args)
    assert set(tres) == set(jres)
    for k in jres:
        np.testing.assert_allclose(tres[k], jres[k], rtol=TOL, atol=1e-7)
        assert tres_in[k] == jres_in[k]


def test_denoise_csv(ifaces, scene_root, tmp_path):
    jif, tif = ifaces
    input_dir = os.path.join(scene_root, "test", "input")
    kw = dict(spps=(4,), use_llpm_buf=True)
    jev.denoise(jif, input_dir, "kpcn", output_dir=str(tmp_path / "j"), **kw)
    tev.denoise(tif, input_dir, "kpcn", output_dir=str(tmp_path / "t"), **kw)
    for name in ("results_4.csv", "results_input_4.csv"):
        with open(tmp_path / "j" / name) as f:
            jrows = list(csv.DictReader(f))
        with open(tmp_path / "t" / name) as f:
            trows = list(csv.DictReader(f))
        assert [list(r) for r in trows] == [list(r) for r in jrows]
        for jr, tr in zip(jrows, trows):
            for k in jr:
                if k in ("scene", "spp"):
                    assert tr[k] == jr[k]
                elif k != "inference_sec":
                    np.testing.assert_allclose(float(tr[k]), float(jr[k]),
                                               rtol=TOL, atol=1e-7)


def test_jax_checkpoint_restores(ifaces, tmp_path):
    """A checkpoint written by wcmc_tpu's save_checkpoint, read by the
    port into a freshly initialized interface, gives the same output."""
    jif, _ = ifaces
    path = str(tmp_path / "KPCN_ckpt.ckpt")
    save_checkpoint(path, jif, epoch=3)
    ck = load_checkpoint(path)
    assert ck["start_epoch"] == 4
    tif = tinit(TConfig(**CFG, seed=2), device="cpu")[0]
    restore_interface(tif, ck)
    rng = np.random.default_rng(1)
    batch = {k: np.array(v) for k, v in synthetic_batch(
        rng, "kpcn", batch_size=1, patch=48, spp=2, use_llpm_buf=True).items()}
    jrad, _ = jif.validate_batch({k: jnp.asarray(v) for k, v in batch.items()})
    trad, _ = tif.validate_batch(batch)
    _close(trad, jrad)
    # the same file through the port's CLI entry point
    args = ttm.parse_args(["--model_name", "KPCN_ckpt", "--save", str(tmp_path),
                           "--data_dir", str(tmp_path), "--use_llpm_buf",
                           "--kpcn_ksize", "5", "--compute_dtype", "float32",
                           "--device", "cpu"])
    cli_if, base = ttm.build_interface(args)
    assert base == "kpcn"
    _close(cli_if.validate_batch(batch)[0], jrad)


def test_validate_batch_bf16():
    """The serving dtype: bf16 activations over f32 params, against the
    wcmc_tpu interface in bf16 with its Pallas kernels (K1, K4-fwd,
    K5-fwd) in interpret mode, on converted weights.  Both round at the
    same points; a bf16 product summed in another order can round to a
    neighbouring value, and that flip travels through the 9-layer KPCN
    and the PathNet: about 4e-3 of max |ref| at worst on this batch
    (wcmc_tpu's own XLA and Pallas paths differ by 2e-3), held to 1e-2.
    The interface is fresh, so its jitted step is traced with the
    Pallas kernels on."""
    import importlib

    jmf = importlib.import_module("wcmc_tpu.ops.mlp_fused")
    jpk = importlib.import_module("wcmc_tpu.ops.pallas_kernels")
    cfg = dict(CFG, compute_dtype="bfloat16")
    jif = jinit(JConfig(**cfg))[0]
    tif = tinit(TConfig(**cfg, seed=1), device="cpu")[0]
    for name, state in jif.states.items():
        convert.load_flax_params(tif.models[name], state.params)
    rng = np.random.default_rng(5)
    batch = {k: np.array(v) for k, v in synthetic_batch(
        rng, "kpcn", batch_size=2, patch=48, spp=2, use_llpm_buf=True).items()}
    jif.to_eval_mode()
    tif.to_eval_mode()
    tif.preprocess(batch)
    jpk.INTERPRET, jmf.FORCE_PALLAS = True, True
    try:
        jrad, jp = jif.validate_batch({k: jnp.asarray(v) for k, v in batch.items()})
    finally:
        jpk.INTERPRET, jmf.FORCE_PALLAS = False, False
    trad, tp = tif.validate_batch(batch)
    _close(trad, jrad, BF16_TOL)
    for k in jp:
        _close(tp[k], jp[k], BF16_TOL)


@pytest.mark.parametrize("mode", ["m11r11", "m10r01", "m11r01", "m10r11"])
def test_split_disentangle(mode):
    from wcmc_tpu.train.interfaces import split_disentangle as jsplit
    from wcmc_tpu_torch.train.interfaces import split_disentangle as tsplit

    x = np.random.default_rng(3).standard_normal((2, 3, 5, 4, 6)).astype(np.float32)
    for axis in (-1, 2):
        want = jsplit(jnp.asarray(x), mode, axis=axis)
        got = tsplit(torch.from_numpy(x), mode, axis=axis)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_unported_families_raise(tmp_path):
    """SBMC (slice E) raises by name and by config; LBMC is ported."""
    args = ttm.parse_args(["--model_name", "SBMC_x", "--data_dir", str(tmp_path),
                           "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="slice E"):
        ttm.build_interface(args)
    with pytest.raises(NotImplementedError, match="slice E"):
        tinit(TConfig(base_model="sbmc"), device="cpu")
    assert str(tinit(TConfig(base_model="lbmc"), device="cpu")[0]) == "LBMCInterface"


@pytest.mark.parametrize("base", ["kpcn", "lbmc"])
def test_model_names_build_the_reference_config(tmp_path, base):
    """A KPCN or LBMC model name builds the config the reference's
    ``train_kpcn.make_config`` / ``train_lbmc.make_config`` builds from the
    same flags."""
    import dataclasses

    import train_kpcn
    import train_lbmc

    argv = ["--model_name", f"{base.upper()}_x", "--data_dir", str(tmp_path),
            "--device", "cpu", "--use_llpm_buf", "--manif_learn", "--manif_loss", "FMSE",
            "--compute_dtype", "float32", "--lr_pnet", "3e-4", "--seed", "4",
            "--kpcn_ksize", "5"]
    args = ttm.parse_args(argv)
    want = {"kpcn": train_kpcn, "lbmc": train_lbmc}[base].make_config(args)
    got = ttm.model_config(args, base)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    iface, got_base = ttm.build_interface(args)
    assert got_base == base
    if base == "lbmc":
        assert set(iface.models) == {"dncnn", "backbone"}
        assert iface.models["dncnn"].n_in == 29
