"""Checkpoints between the port and wcmc_tpu, both ways (f32, CPU).

The port writes wcmc_tpu's format 2 (``wcmc_tpu_torch/train/checkpoint.py``):
the flax param trees (``convert.to_flax``) and optax's flattened optimizer
state, whose classes the port writes as optax's global references without
importing optax.  For KPCN (ksize 5) and LBMC (with the single PathNet and
a warmup of 5 steps), manifold learning off so the two packages' steps are
comparable:

* the port takes 2 steps and saves; wcmc_tpu's ``load_checkpoint`` +
  ``restore_interface`` read the file as optax's classes: its params are
  ``to_flax`` of the port's, its Adam ``mu`` / ``nu`` the port's moments
  raveled in flax order, bit for bit, and its counts and learning rate
  the port's;
* one more step on each side from there: each model's Adam moments within
  5e-3 of their max (LBMC's PathNet, trained here only through the
  denoiser, has gradients of ~1e-6 whose f32 sums differ by ~1e-3 of their
  max between the packages; a moment that was not carried across would be
  off by 0.9 of it), its params within 1e-6 where the step's |g| exceeds
  1e-4 of its max and 1e-5, within 2 lr everywhere (a first-moment sign
  decides where |g| is within the gradients' error of zero, as in
  ``test_torch_train_step.py``), and within 1e-5 of the model's max |p| by
  relative L2;
* wcmc_tpu saves that state; the port restores it bit for bit and the
  next step matches the same way;
* ``lr_override``, the warmup count carried across, and a shape mismatch
  raising ``ValueError``.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from wcmc_tpu.data.batches import synthetic_batch as jsynth
from wcmc_tpu.train import checkpoint as jck
from wcmc_tpu.train.factory import TrainConfig as JConfig
from wcmc_tpu.train.factory import init_interfaces as jinit
from wcmc_tpu.train.state import get_learning_rate as jget_lr
from wcmc_tpu_torch import convert
from wcmc_tpu_torch.data.batches import synthetic_batch as tsynth
from wcmc_tpu_torch.train import checkpoint as tck
from wcmc_tpu_torch.train.factory import TrainConfig as TConfig
from wcmc_tpu_torch.train.factory import init_interfaces as tinit


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: a parallel test run shares the cores among its
    workers, and more threads a worker mostly spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)

LR = 1e-4
GRAD_TOL, PARAM_TOL, MOMENT_TOL, L2_TOL = 1e-4, 1e-6, 5e-3, 1e-5
FAMILIES = {
    # family: (config, batch seed, patch); seeds free of relu ties at f32
    "kpcn": (dict(base_model="kpcn", kpcn_ksize=5), 1, 48),
    "lbmc": (dict(base_model="lbmc", use_llpm_buf=True, warmup_steps=5), 3, 32),
}


def _cfg(family, **kw):
    cfg, _, _ = FAMILIES[family]
    return dict(cfg, compute_dtype="float32", finite_check_every=1, lr_dncnn=LR,
                lr_pnet=(LR,), **kw)


def _port(family, **kw):
    return tinit(TConfig(**_cfg(family, **kw), seed=1), device="cpu")[0]


def _batches(family):
    _, seed, patch = FAMILIES[family]
    llpm = FAMILIES[family][0].get("use_llpm_buf", False)
    jb = jsynth(np.random.default_rng(seed), family, batch_size=2, patch=patch, spp=2,
                use_llpm_buf=llpm)
    tb = tsynth(np.random.default_rng(seed), family, batch_size=2, patch=patch, spp=2,
                use_llpm_buf=llpm)
    return jb, tb


def _jax_moments(jif, name):
    inject = jif.states[name].opt_state[1]
    adam = inject.inner_state[0]
    return inject, adam


def _port_moments(tif, name):
    """The port's Adam moments of ``name`` raveled in flax order, and its
    step count."""
    host = tck.optim_state(tif.models[name], tif.optims["optim_" + name])
    count, hyper, _, inner = host[1].args
    _, mu, nu = inner[0].args
    return mu, nu, int(count), host


def _assert_same_state(jif, tif):
    """Params, moments, counts and learning rates equal bit for bit."""
    for name, model in tif.models.items():
        got = jax.tree_util.tree_leaves(convert.to_flax(model))
        want = jax.tree_util.tree_leaves(jif.states[name].params)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
        inject, adam = _jax_moments(jif, name)
        mu, nu, count, host = _port_moments(tif, name)
        np.testing.assert_array_equal(mu, np.asarray(adam.mu))
        np.testing.assert_array_equal(nu, np.asarray(adam.nu))
        assert count == int(adam.count) == int(inject.count)
        assert jget_lr(jif.states[name].opt_state) == pytest.approx(
            tif.optims["optim_" + name].lr, rel=1e-7)
        opt_state = jif.states[name].opt_state
        if len(opt_state) > 2:       # the warmup's count
            assert int(opt_state[2].count) == tif.optims["optim_" + name].count


def _step_both(jif, tif, jb, tb):
    """One more step on each side; the port's gradient of that step (in
    flax layout) picks the elements a sign can flip."""
    tif.to_train_mode()
    tif.preprocess(tb)
    tif.train_batch(tb, grad_hook_mode=True)
    grads = {n: jax.tree_util.tree_leaves(convert.grads_to_flax(m))
             for n, m in tif.models.items()}
    tif.preprocess(tb)
    tif.train_batch(tb)
    jif.to_train_mode()
    jif.preprocess(jb)
    jif.train_batch(jb)
    for name, model in tif.models.items():
        got = jax.tree_util.tree_leaves(convert.to_flax(model))
        want = [np.asarray(w) for w in jax.tree_util.tree_leaves(jif.states[name].params)]
        for g, w, gr in zip(got, want, grads[name]):
            gr = np.abs(gr)
            diff = np.abs(g - w)
            sure = (gr > GRAD_TOL * gr.max()) & (gr > 1e-5)
            assert diff[sure].max(initial=0.0) <= PARAM_TOL, name
            assert diff.max() <= 2 * LR + PARAM_TOL, name
        flat_g = np.concatenate([x.ravel() for x in got]).astype(np.float64)
        flat_w = np.concatenate([x.ravel() for x in want]).astype(np.float64)
        assert np.linalg.norm(flat_g - flat_w) <= L2_TOL * np.linalg.norm(flat_w), name
        _, adam = _jax_moments(jif, name)
        mu, nu, _, _ = _port_moments(tif, name)
        for a, b in ((mu, adam.mu), (nu, adam.nu)):
            b = np.asarray(b)
            assert np.abs(a - b).max() <= MOMENT_TOL * np.abs(b).max(), name


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    return request.param


def test_checkpoint_interop_both_ways(family, tmp_path):
    jif = jinit(JConfig(**_cfg(family)))[0]
    tif = _port(family)
    for name, st in jif.states.items():
        convert.load_flax_params(tif.models[name], st.params)
    jb, tb = _batches(family)

    # the port writes
    tif.to_train_mode()
    for _ in range(2):
        tif.preprocess(tb)
        tif.train_batch(tb)
    tif.best_err = 0.25
    path = str(tmp_path / "port.ckpt")
    tck.save_checkpoint(path, tif, epoch=4, description="port run")
    assert not (tmp_path / "port.ckpt.tmp").exists()
    ck = jck.load_checkpoint(path)
    assert ck["format_version"] == jck.FORMAT_VERSION == tck.FORMAT_VERSION
    assert (ck["start_epoch"], ck["best_err"], ck["description"], ck["model"]) == (
        5, 0.25, "port run", str(tif))
    assert type(ck["optim_dncnn"][1]).__module__.startswith("optax")
    jck.restore_interface(jif, ck)
    assert jif.best_err == 0.25
    _assert_same_state(jif, tif)
    _step_both(jif, tif, jb, tb)

    # wcmc_tpu writes
    path = str(tmp_path / "jax.ckpt")
    jck.save_checkpoint(path, jif, epoch=0)
    fresh = _port(family)
    tck.restore_interface(fresh, tck.load_checkpoint(path))
    _assert_same_state(jif, fresh)
    _step_both(jif, fresh, jb, tb)


def test_port_checkpoint_round_trip_and_lr_override(tmp_path):
    """The port reads its own file back bit for bit; ``lr_override``
    replaces the learning rate; the warmup count carries; ``load_optim``
    False keeps the optimizer as it was."""
    tif = _port("lbmc")
    _, tb = _batches("lbmc")
    tif.to_train_mode()
    for _ in range(3):
        tif.preprocess(tb)
        tif.train_batch(tb)
    path = str(tmp_path / "a.ckpt")
    tck.save_checkpoint(path, tif, epoch=0)
    ck = tck.load_checkpoint(path)
    other = _port("lbmc")
    tck.restore_interface(other, ck, lr_override={"dncnn": 5e-6})
    assert other.optims["optim_dncnn"].lr == 5e-6
    assert other.optims["optim_backbone"].lr == pytest.approx(LR)
    for name, model in tif.models.items():
        opt, got = tif.optims["optim_" + name], other.optims["optim_" + name]
        assert got.count == opt.count == 3
        for p, q in zip(model.parameters(), other.models[name].parameters()):
            assert torch.equal(p, q)
            for key in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(opt.adam.state[p][key], got.adam.state[q][key])
            assert int(got.adam.state[q]["step"]) == 3
    fresh = _port("lbmc")
    tck.restore_interface(fresh, ck, load_optim=False)
    assert fresh.optims["optim_dncnn"].count == 0 and not fresh.optims["optim_dncnn"].adam.state
    # a model of other widths: ValueError
    wide = _port("lbmc", pnet_out_size=(4,))
    with pytest.raises(ValueError):
        tck.restore_interface(wide, ck)
    # a warmup in the file but none in the build: ValueError
    cold = _port("lbmc", warmup_steps=0)
    with pytest.raises(ValueError, match="warmup"):
        tck.restore_interface(cold, ck)


def test_unstepped_optimizer_round_trip(tmp_path):
    """A model saved before its first step: zero moments and count, read
    back as a fresh Adam (no state), and wcmc_tpu reads it too."""
    tif = _port("kpcn")
    path = str(tmp_path / "b.ckpt")
    tck.save_checkpoint(path, tif, epoch=0)
    ck = tck.load_checkpoint(path)
    inject = ck["optim_dncnn"][1]
    assert int(inject.args[0]) == 0
    assert not np.asarray(inject.args[3][0].args[1]).any()
    other = _port("kpcn")
    tck.restore_interface(other, ck)
    assert not other.optims["optim_dncnn"].adam.state
    jif = jinit(JConfig(**_cfg("kpcn")))[0]
    jck.restore_interface(jif, jck.load_checkpoint(path))
    _assert_same_state(jif, other)
