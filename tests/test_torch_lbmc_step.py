"""The ported LBMC + manifold training step and validation against
wcmc_tpu's, through the interfaces ``init_interfaces`` builds.

* One full f32 step of the flagship LBMC configuration (LayerNet K = 13
  with the single PathNet, FMSE with roll pairing, non-local, w_manif
  0.1, Adam with global-norm clip 250) from the same parameters (carried
  by ``convert``), the same batch (``synthetic_batch`` from one numpy
  seed on each side, 2 patches of 32 px at 2 spp) and the same draws
  (the reference's key, replayed): the loss dict within 1e-5 relative;
  each gradient tensor within 2e-4 of its max |g| (f32 summed in another
  order through the per-pixel MLP, the U-Nets and the gathers; measured
  at most 4.8e-5 on this seed, 7.5e-5 on seed 4, both in the layer
  head's bias, a sum of softmax derivatives that nearly cancel); updated
  parameters within 1e-6 wherever |g| > 2e-4 max|g| and |g| > 1e-5,
  within 2 lr everywhere (a first Adam
  step moves a parameter by about +-lr whatever |g| is, so where |g| is
  within the gradients' own error of zero its sign decides).  The batch
  seed is one on which no (leaky) relu pre-activation of either side
  lies within rounding of zero; where one does, every gradient below it
  moves by up to a few 1e-2 of its max (seeds 0, 1, 2 and 5 of this
  batch do that, by up to 8.6e-3).
* ``validate_batch``: radiance and the reconstruction p-buffer within
  1e-5 of max |ref|, and the accumulated ``l_test``.
* Tiled inference of a 192x192 4-spp synthetic scene (2 samples cached
  plus an extra-spp part, SBMC caches written by the port) through the
  port's ``test_models.main`` reading a checkpoint that wcmc_tpu wrote,
  against wcmc_tpu's ``denoise`` with the same interface: the metric grid
  within 1e-4 relative, and the ``rhf`` export of the bare p-buffer
  within 1e-5 of max |ref|.
* The variance feature passes no gradient to the PathNet; the p-buffer
  itself does.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wcmc_tpu import evaluate as jev
from wcmc_tpu.data.batches import synthetic_batch as jsynth
from wcmc_tpu.train.checkpoint import save_checkpoint
from wcmc_tpu.train.factory import TrainConfig as JConfig
from wcmc_tpu.train.factory import init_interfaces as jinit
from wcmc_tpu_torch import convert
from wcmc_tpu_torch import evaluate as tev
from wcmc_tpu_torch import losses as tl
from wcmc_tpu_torch import test_models as ttm
from wcmc_tpu_torch.data.batches import synthetic_batch as tsynth
from wcmc_tpu_torch.data.dataset import offline_preprocess
from wcmc_tpu_torch.data.synthetic import build_synthetic_dataset
from wcmc_tpu_torch.ops import _build
from wcmc_tpu_torch.train.factory import TrainConfig as TConfig
from wcmc_tpu_torch.train.factory import init_interfaces as tinit

LOSS_TOL, GRAD_TOL, PARAM_TOL, OUT_TOL = 1e-5, 2e-4, 1e-6, 1e-5
LR = 1e-3
BATCH_SEED = 3
CFG = dict(base_model="lbmc", use_llpm_buf=True, manif_learn=True, manif_loss="FMSE",
           finite_check_every=1, lr_dncnn=LR, lr_pnet=(LR,), compute_dtype="float32")


def _close(got, want, tol):
    got = np.asarray(torch.as_tensor(got).detach().float(), np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= tol * max(np.max(np.abs(want)), 1e-30)


def jax_draws(key, p_shape):
    """The roll draws of wcmc_tpu's manifold loss from ``key`` for a
    channels-last (B,S,H,W,C) p-buffer."""
    n_patch, n_batch = tl.positions(p_shape)
    out = {}
    for name, k, n in zip(("patch", "batch"), jax.random.split(key), (n_patch, n_batch)):
        k1, k2 = jax.random.split(k)
        out[name] = (int(jax.random.randint(k1, (), 0, n)), int(jax.random.randint(k2, (), 1, n)))
    return out


@pytest.fixture(scope="module")
def pair():
    jif = jinit(JConfig(**CFG))[0]
    tif = tinit(TConfig(**CFG, seed=1), device="cpu")[0]
    assert str(tif) == "LBMCInterface" and set(tif.models) == set(jif.states)
    for name, st in jif.states.items():
        convert.load_flax_params(tif.models[name], st.params)
    return jif, tif


def _batches(seed, b=2, patch=32, spp=2):
    """The same synthetic batch built by each package from one seed."""
    jb = jsynth(np.random.default_rng(seed), "lbmc", batch_size=b, patch=patch, spp=spp,
                use_llpm_buf=True)
    tb = tsynth(np.random.default_rng(seed), "lbmc", batch_size=b, patch=patch, spp=spp,
                use_llpm_buf=True)
    assert set(jb) == set(tb) == {"radiance", "features", "target_image", "paths"}
    assert tb["features"].shape[-1] == 25
    for k in jb:
        want = np.asarray(jb[k])
        np.testing.assert_allclose(tb[k].numpy(), want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max())
    return jb, tb


def _jax_loss_fn(jif):
    step = jif._make_train_step()
    fns = {c.cell_contents.__name__: c.cell_contents for c in step.__closure__
           if callable(c.cell_contents) and hasattr(c.cell_contents, "__name__")}
    return fns["loss_fn"]


def test_lbmc_train_step_f32(pair):
    jif, tif = pair
    jb, tb = _batches(BATCH_SEED)
    _, sub = jax.random.split(jif._key)
    b, s, h, w = jb["radiance"].shape[:4]
    draws = jax_draws(sub, (b, s, h, w, tif.models["backbone"].outc))
    params = {n: jif.states[n].params for n in jif.states}
    jgrads, jloss = jax.jit(jax.grad(_jax_loss_fn(jif), has_aux=True))(params, jb, sub)
    tif.to_train_mode()
    tif.preprocess(tb)
    _build.reset_counts()
    tloss = tif.train_batch(tb, grad_hook_mode=True, draws=draws)
    assert not _build.launches
    assert set(tloss) == set(jloss) == {"l_manif", "l_recon", "l_total", "rmse"}
    for k, v in jloss.items():
        assert abs(float(tloss[k]) - float(v)) <= LOSS_TOL * abs(float(v)), k
    flat_j = {}
    for name, model in tif.models.items():
        got = jax.tree_util.tree_leaves_with_path(convert.grads_to_flax(model))
        want = jax.tree_util.tree_leaves_with_path(jgrads[name])
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, g), (_, wv) in zip(got, want):
            _close(g, wv, GRAD_TOL)
        flat_j[name] = want

    jif.to_train_mode()
    jif.preprocess(jb)
    jif.train_batch(jb)
    tif.preprocess(tb)
    tif.train_batch(tb, draws=draws)
    for name, model in tif.models.items():
        got = jax.tree_util.tree_leaves(convert.to_flax(model))
        new = jax.tree_util.tree_leaves(jif.states[name].params)
        for g, wv, (_, jg) in zip(got, new, flat_j[name]):
            wv, jg = np.asarray(wv), np.abs(np.asarray(jg))
            diff = np.abs(g - wv)
            sure = (jg > GRAD_TOL * jg.max()) & (jg > 1e-5)
            assert diff[sure].max(initial=0.0) <= PARAM_TOL
            assert diff.max() <= 2 * LR + PARAM_TOL


def test_lbmc_validate_batch(pair):
    jif, tif = pair
    jb, tb = _batches(2)
    jif.to_eval_mode()
    tif.to_eval_mode()
    tif.preprocess(tb)
    jrad, jp = jif.validate_batch(jb)
    trad, tp = tif.validate_batch(tb)
    _close(trad, jrad, OUT_TOL)
    assert tp.shape == (2, 2, 32, 32, 3)
    _close(tp, jp, OUT_TOL)
    np.testing.assert_allclose(float(tif.m_losses["m_val"]), float(jif.m_losses["m_val"]),
                               rtol=1e-4)


def test_variance_feature_passes_no_gradient(pair):
    _, tif = pair
    _, tb = _batches(3, patch=16)
    net_batch, p_manif, p_recon = tif._augment_features(tif.to_device(tb))
    params = list(tif.models["backbone"].parameters())
    feat = net_batch["features"][..., -1].sum()         # variance / spp
    pbuf = net_batch["features"][..., -4:-1].sum()      # the 3 p-buffer channels
    assert all(not g.any() for g in torch.autograd.grad(feat, params, retain_graph=True,
                                                        allow_unused=True) if g is not None)
    assert any(g.any() for g in torch.autograd.grad(pbuf, params, retain_graph=True))
    assert p_manif.requires_grad and p_manif is p_recon
    want = p_recon.var(dim=1, unbiased=True).mean(dim=-1) / p_recon.shape[1]
    torch.testing.assert_close(net_batch["features"][:, 0, ..., -1], want.detach())


def test_lbmc_nonfinite_loss_raises(pair):
    _, tif = pair
    _, tb = _batches(4, patch=16)
    bad = dict(tb)
    bad["target_image"] = torch.full_like(tb["target_image"], float("nan"))
    tif.to_train_mode()
    tif.iters = 0
    tif.preprocess(bad)
    with pytest.raises(RuntimeError, match="Non-finite"):
        tif.train_batch(bad)
    with pytest.raises(KeyError):
        tif.preprocess({k: v for k, v in tb.items() if k != "paths"})


def test_lbmc_tiled_inference_through_test_models(pair, tmp_path):
    jif, _ = pair
    root = str(tmp_path / "data")
    build_synthetic_dataset(root, n_train=0, n_val=0, n_test=1, size=192, spp=2,
                            test_extra_parts=1, seed=11)
    offline_preprocess(root, mode="test", spp=2, sbmc=True, kpcn=False, device="cpu")
    save_checkpoint(str(tmp_path / "LBMC_ckpt.ckpt"), jif, epoch=0)
    input_dir = os.path.join(root, "test", "input")
    args = ttm.parse_args(["--model_name", "LBMC_ckpt", "--save", str(tmp_path),
                           "--data_dir", root, "--spps", "4", "--use_llpm_buf",
                           "--compute_dtype", "float32", "--device", "cpu",
                           "--output_dir", str(tmp_path / "t")])
    _build.reset_counts()
    results, cli_if = ttm.main(args)
    assert str(cli_if) == "LBMCInterface" and not _build.launches
    assert _build.plain_calls["mlp_fused"] == _build.plain_calls["gather_softmax"] // 2 == 1
    jres = jev.denoise(jif, input_dir, "lbmc", spps=(4,), use_llpm_buf=True,
                       output_dir=str(tmp_path / "j"))
    got, want = results[("scene0", 4)], jres[("scene0", 4)]
    for which in ("output", "input"):
        for k, v in want[which].items():
            if k != "inference_sec":
                np.testing.assert_allclose(got[which][k], v, rtol=1e-4, atol=1e-7)
    kw = dict(spps=(4,), use_llpm_buf=True, rhf=True)
    assert tev.denoise(cli_if, input_dir, "lbmc", output_dir=str(tmp_path / "tr"), **kw) == {}
    jev.denoise(jif, input_dir, "lbmc", output_dir=str(tmp_path / "jr"), **kw)
    name = "p_buffer_scene0_4.npy"
    pb = np.load(tmp_path / "tr" / name)
    assert pb.shape == (4, 192, 192, 3)
    _close(pb, np.load(tmp_path / "jr" / name), OUT_TOL)
