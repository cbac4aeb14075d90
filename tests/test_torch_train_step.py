"""The ported KPCN + manifold training step against wcmc_tpu's.

* Optimizer: ``adam_with_clip`` (value clip, global-norm clip, Adam,
  warmup, ``set_learning_rate``) against the optax chain on the same
  gradients for 3 steps: within 1e-6.
* One full f32 step (dual PathNet, FMSE with roll pairing, Adam with
  value clip 1.0) from the same parameters (carried by ``convert``), the
  same batch (``synthetic_batch`` from one numpy seed on each side) and
  the same draws (the reference's key, replayed), in disentangle modes
  m11r11 and m10r01 with ``train_branches``, and once without: the loss
  dict within 1e-5 relative; each gradient tensor within 1e-4 of its
  max |g| (f32 summed in another order through ~25 stacked
  convolutions); updated parameters within 1e-6 wherever |g| > 1e-4
  max|g| and |g| > 1e-5, within 2 lr everywhere.  A first Adam step
  moves a parameter by lr g / (|g| + eps), eps = 1e-8: about +-lr
  whatever |g| is, so where |g| is within the gradients' own error of
  zero its sign decides, and where |g| is near eps the gradients' error
  moves it by more than 1e-6.  The batch seed is
  one on which no pre-activation of either side lies within rounding of
  zero: where one does, the two frameworks can disagree on its relu and
  every gradient below that layer moves by up to a few 1e-2 of its max
  (seeds 0, 2-7 of this batch do that; the gradients here agree within
  1.4e-5).
* The same step in bf16 (the compute dtype of the flagship) against
  wcmc_tpu in bf16 with its Pallas kernels in interpret mode.
* Repairs: the variance feature passes no gradient, and ``TrainConfig``
  carries the reference's training fields, defaults and cross-flag
  rules.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from wcmc_tpu.data.batches import synthetic_batch as jsynth
from wcmc_tpu.train import state as jstate
from wcmc_tpu.train.factory import TrainConfig as JConfig
from wcmc_tpu.train.factory import init_interfaces as jinit
from wcmc_tpu_torch import convert
from wcmc_tpu_torch import losses as tl
from wcmc_tpu_torch.data.batches import synthetic_batch as tsynth
from wcmc_tpu_torch.ops import _build
from wcmc_tpu_torch.train import state as tstate
from wcmc_tpu_torch.train.factory import TrainConfig as TConfig
from wcmc_tpu_torch.train.factory import init_interfaces as tinit

jmf = importlib.import_module("wcmc_tpu.ops.mlp_fused")
jpk = importlib.import_module("wcmc_tpu.ops.pallas_kernels")

LOSS_TOL, GRAD_TOL, PARAM_TOL = 1e-5, 1e-4, 1e-6
LR = 1e-3
CFG = dict(base_model="kpcn", kpcn_ksize=5, use_llpm_buf=True, manif_learn=True,
           manif_loss="FMSE", finite_check_every=1, lr_dncnn=LR, lr_pnet=(LR,))


def jax_draws(key, p_shape, pairing="roll"):
    """The draws of wcmc_tpu's manifold loss from ``key`` (channel-major
    p-buffers)."""
    n_patch, n_batch = tl.positions(p_shape, cmajor=True)
    k_patch, k_batch = jax.random.split(key)

    def one(k, n):
        if pairing == "permutation":
            return torch.from_numpy(np.array(jax.random.permutation(k, n)))
        k1, k2 = jax.random.split(k)
        return int(jax.random.randint(k1, (), 0, n)), int(jax.random.randint(k2, (), 1, n))

    return {"patch": one(k_patch, n_patch), "batch": one(k_batch, n_batch)}


def _pair(dtype="float32", **kw):
    cfg = dict(CFG, compute_dtype=dtype, **kw)
    jif = jinit(JConfig(**cfg))[0]
    tif = tinit(TConfig(**cfg, seed=1), device="cpu")[0]
    for name, st in jif.states.items():
        convert.load_flax_params(tif.models[name], st.params)
    return jif, tif


def _batches(seed=1, b=2, patch=48, spp=2):
    """The same synthetic batch built by each package from one seed."""
    jb = jsynth(np.random.default_rng(seed), "kpcn", batch_size=b, patch=patch, spp=spp,
                use_llpm_buf=True)
    tb = tsynth(np.random.default_rng(seed), "kpcn", batch_size=b, patch=patch, spp=spp,
                use_llpm_buf=True)
    assert set(jb) == set(tb)
    for k in jb:
        want = np.asarray(jb[k])
        np.testing.assert_allclose(tb[k].numpy(), want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max())
    return jb, tb


def _jax_loss_fn(jif):
    """The reference step's loss function (params, batch, key) -> (loss,
    loss dict), taken from the closure of its train step."""
    step = jif._make_train_step()
    fns = {c.cell_contents.__name__: c.cell_contents for c in step.__closure__
           if callable(c.cell_contents) and hasattr(c.cell_contents, "__name__")}
    return fns["loss_fn"]


def _step_draws(jif, tif, jb):
    """The key of the reference's next step, and the port's draws from it."""
    _, sub = jax.random.split(jif._key)
    if not tif.manif_learn:
        return sub, None
    kd, ks = jax.random.split(sub)
    b, s, h = jb["paths"].shape[:3]
    c = tif.models["backbone_diffuse"].outc
    if tif.disentanglement_option in ("m10r01", "m10r11"):
        c //= 2
    out = h - 4 * 9 - (tif.models["dncnn"].ksize - 1)
    shape = (b, s, c, out, out)
    return sub, {"diffuse": jax_draws(kd, shape), "specular": jax_draws(ks, shape)}


def _close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= tol * max(np.max(np.abs(want)), 1e-30)


def _check_step(jif, tif, jb, tb):
    """Loss dict, gradients and the updated parameters of one step."""
    sub, draws = _step_draws(jif, tif, jb)
    params = {n: jif.states[n].params for n in jif.states}
    jgrads, jloss = jax.jit(jax.grad(_jax_loss_fn(jif), has_aux=True))(params, jb, sub)
    tif.to_train_mode()
    tif.preprocess(tb)
    tloss = tif.train_batch(tb, grad_hook_mode=True, draws=draws)
    assert set(tloss) == set(jloss)
    for k, v in jloss.items():
        assert abs(float(tloss[k]) - float(v)) <= LOSS_TOL * abs(float(v)), k
    flat_j = {}
    for name, model in tif.models.items():
        got = jax.tree_util.tree_leaves_with_path(convert.grads_to_flax(model))
        want = jax.tree_util.tree_leaves_with_path(jgrads[name])
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, g), (_, w) in zip(got, want):
            _close(g, w, GRAD_TOL)
        flat_j[name] = want

    jif.to_train_mode()
    jif.preprocess(jb)
    jif.train_batch(jb)
    tif.preprocess(tb)
    tif.train_batch(tb, draws=draws)
    for name, model in tif.models.items():
        got = jax.tree_util.tree_leaves(convert.to_flax(model))
        new = jax.tree_util.tree_leaves(jif.states[name].params)
        for g, w, (_, jg) in zip(got, new, flat_j[name]):
            w, jg = np.asarray(w), np.abs(np.asarray(jg))
            diff = np.abs(g - w)
            sure = (jg > 1e-4 * jg.max()) & (jg > 1e-5)
            assert diff[sure].max(initial=0.0) <= PARAM_TOL
            assert diff.max() <= 2 * LR + PARAM_TOL
    return tloss


@pytest.mark.parametrize("mode", ["m11r11", "m10r01"])
def test_train_step_f32(mode):
    jif, tif = _pair(disentangle=mode, pnet_out_size=(3,) if mode == "m11r11" else (4,))
    jb, tb = _batches()
    _build.reset_counts()
    _check_step(jif, tif, jb, tb)
    assert not _build.launches


def test_train_step_joint_f32():
    """``train_branches=False``: the joint loss only, no manifold term."""
    jif, tif = _pair(train_branches=False, manif_learn=False, manif_loss=None)
    jb, tb = _batches()
    loss = _check_step(jif, tif, jb, tb)
    assert set(loss) == {"l_total", "rmse"}


def test_train_step_bf16_against_pallas():
    """The flagship's compute dtype: bf16 activations over f32 params,
    against wcmc_tpu in bf16 with its Pallas kernels (K1, K2, K4, K5
    forward and backward) in interpret mode.  A bf16 value summed in
    another order can round to a neighbouring value or take the other
    side of a relu, and that travels through the 9-layer KPCN and the
    PathNet.  On this batch the losses agree within 9.7e-4 relative and
    each model's gradient within cosine 0.9936 and norm ratio 1 +- 0.069
    (wcmc_tpu's own XLA and Pallas bf16 paths differ by 1.3e-3, 0.979 and
    0.050); held to 2.5x: 2.5e-3, 0.984 and 0.17."""
    jif, tif = _pair(dtype="bfloat16")
    jb, tb = _batches(seed=4)
    sub, draws = _step_draws(jif, tif, jb)
    params = {n: jif.states[n].params for n in jif.states}
    jpk.INTERPRET, jmf.FORCE_PALLAS = True, True
    try:
        jgrads, jloss = jax.jit(jax.grad(_jax_loss_fn(jif), has_aux=True))(params, jb, sub)
    finally:
        jpk.INTERPRET, jmf.FORCE_PALLAS = False, False
    tif.to_train_mode()
    tif.preprocess(tb)
    tloss = tif.train_batch(tb, grad_hook_mode=True, draws=draws)
    for k, v in jloss.items():
        assert abs(float(tloss[k]) - float(v)) <= 2.5e-3 * abs(float(v)), k
    for name, model in tif.models.items():
        a = np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(
            convert.grads_to_flax(model))]).astype(np.float64)
        b = np.concatenate([np.ravel(np.asarray(x, np.float64))
                            for x in jax.tree_util.tree_leaves(jgrads[name])])
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
        ratio = np.linalg.norm(a) / np.linalg.norm(b)
        assert cos >= 0.984 and abs(ratio - 1) <= 0.17, (name, cos, ratio)


def test_variance_feature_passes_no_gradient():
    _, tif = _pair()
    _, tb = _batches(seed=5)
    tif.to_train_mode()
    net_batch, manif = tif._forward_with_paths(tif.to_device(tb))
    params = [p for name in ("backbone_diffuse", "backbone_specular")
              for p in tif.models[name].parameters()]
    for key in ("kpcn_diffuse_in", "kpcn_specular_in"):
        feat = net_batch[key][..., -1].sum()        # variance / spp
        mean = net_batch[key][..., -4:-1].sum()     # the 3 mean channels
        assert all(not g.any() for g in torch.autograd.grad(feat, params, retain_graph=True))
        assert any(g.any() for g in torch.autograd.grad(mean, params, retain_graph=True))
    assert manif["diffuse"].requires_grad


def test_optimizer_matches_optax():
    rng = np.random.default_rng(6)
    shapes = [(4, 3), (7,), (2, 2, 3)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(3 * rng.standard_normal(s)).astype(np.float32) for s in shapes]
             for _ in range(3)]
    tx = jstate.adam_with_clip(1e-2, clip_value=1.5, clip_norm=2.0, warmup_steps=2)
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = tstate.adam_with_clip(tp, 1e-2, clip_value=1.5, clip_norm=2.0, warmup_steps=2)
    for step, g in enumerate(grads):
        if step == 2:
            jstate.set_learning_rate(opt_state, 3e-3)
            tstate.set_learning_rate(opt, 3e-3)
        updates, opt_state = tx.update([jnp.asarray(x) for x in g], opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x.copy())
        opt.step()
        for p, w in zip(tp, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), rtol=0, atol=1e-6)
    assert tstate.get_learning_rate(opt) == 3e-3
    assert tstate.param_count(tp) == sum(int(np.prod(s)) for s in shapes)
    with pytest.raises(ValueError):
        tstate.get_learning_rate(torch.optim.SGD(tp, lr=0.1))
    with pytest.raises(ValueError):
        tstate.set_learning_rate(object(), 0.1)


def test_train_config_matches_the_reference():
    tfields = {f.name: f.default for f in dataclasses.fields(TConfig)}
    jfields = {f.name: f.default for f in dataclasses.fields(JConfig)}
    for name in ("model_name", "batch_size", "spp", "patch_size", "lr_dncnn",
                 "manif_learn", "manif_loss", "local", "manif_pairing", "train_branches",
                 "finite_check_every", "warmup_steps"):
        assert tfields[name] == jfields[name], name
    for name, default in tfields.items():
        assert jfields[name] == default, name


@pytest.mark.parametrize("bad", [
    dict(manif_learn=True, manif_loss="FMSE"),                       # no llpm buffer
    dict(use_llpm_buf=True, manif_learn=True),                        # no loss
    dict(manif_loss="FMSE"),                                          # loss without module
    dict(use_llpm_buf=True, manif_learn=True, manif_loss="MSE"),      # unknown loss
    dict(disentangle="m01r10"),
    dict(disentangle="m10r01", pnet_out_size=(3,)),
])
def test_train_config_rejects(bad):
    for cfg in (JConfig, TConfig):
        with pytest.raises(ValueError):
            cfg(**bad).validate()


def test_nonfinite_loss_raises_and_summary():
    _, tif = _pair(manif_learn=False, manif_loss=None)
    _, tb = _batches(seed=7)
    tif.to_train_mode()
    tif.preprocess(tb)
    loss = tif.train_batch(tb)
    summary = tif.get_epoch_summary("train", norm=1)
    assert summary == -1.0 and float(tif.m_losses["m_l_total"]) == 0.0
    assert np.isfinite(float(loss["l_total"]))
    bad = dict(tb)
    bad["target_total"] = torch.full_like(tb["target_total"], float("nan"))
    tif.preprocess(bad)
    with pytest.raises(RuntimeError, match="Non-finite"):
        tif.train_batch(bad)
    with pytest.raises(NotImplementedError):
        tif.to_mesh(None)


def test_crop_hw_and_p_buffer_variance():
    from wcmc_tpu.train import interfaces as jitf
    from wcmc_tpu_torch.train import interfaces as titf

    rng = np.random.default_rng(8)
    p = rng.standard_normal((2, 4, 7, 6, 3)).astype(np.float32)
    _close(titf.p_buffer_variance(torch.from_numpy(p)),
           jitf.p_buffer_variance(jnp.asarray(p)), 1e-6)
    x = rng.standard_normal((2, 3, 3, 11, 9)).astype(np.float32)
    np.testing.assert_array_equal(titf.crop_hw(torch.from_numpy(x), 6, 4).numpy(),
                                  np.asarray(jitf.crop_hw(jnp.asarray(x), 6, 4)))
