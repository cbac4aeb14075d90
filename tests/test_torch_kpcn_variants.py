"""The KPCN ref and pre variants of the port against wcmc_tpu's.

* ``KPCNRefInterface`` (the oracle ablation: the target diffuse and
  specular radiance joined onto KPCN's inputs, so the dncnn is 3 channels
  wider): ``convert`` carries the wider first layer both ways; one f32
  train step and one validation batch against the reference's from the
  same parameters and batch.
* ``KPCNPreInterface`` (the two-phase schedule): phase (a), the dual
  PathNet alone under FMSE with the reference's draws injected, only the
  backbones updating; phase (b), KPCN under the frozen PathNet, only the
  dncnn updating; one f32 step each.  The model a phase freezes keeps its
  parameters bit for bit.

Tolerances (f32 on both sides, ksize 5, 48 px, 2 spp): the loss dict
within 1e-5 relative, each gradient tensor within 1e-4 of its max |g|,
updated parameters within 1e-6 where |g| is clear of zero (> 1e-4 max|g|
and > 1e-5), within 2 lr everywhere (the rule of
``test_torch_train_step.py``: a first Adam step moves a parameter by about
lr whatever |g| is, so where |g| is within the gradients' own error of zero
its sign decides).

* The entry points: ``python -m wcmc_tpu_torch.train_kpcn --kpcn_ref``
  and ``--kpcn_pre`` (phase (a)) for one epoch each on a tiny corpus on
  the CPU, and
  ``wcmc_tpu_torch.test_models --kpcn_ref`` serving the ref checkpoint
  (through ``_augment``: the tiles carry the targets).
"""

import os

import jax
import numpy as np
import pytest
import torch

from wcmc_tpu.data.batches import synthetic_batch as jsynth
from wcmc_tpu.train.factory import TrainConfig as JConfig
from wcmc_tpu.train.factory import init_interfaces as jinit
from wcmc_tpu_torch import convert, train_kpcn
from wcmc_tpu_torch import losses as tl
from wcmc_tpu_torch import test_models as ttm
from wcmc_tpu_torch.data.batches import synthetic_batch as tsynth
from wcmc_tpu_torch.data.dataset import offline_preprocess
from wcmc_tpu_torch.data.synthetic import build_synthetic_dataset
from wcmc_tpu_torch.ops import _build
from wcmc_tpu_torch.train.checkpoint import load_checkpoint
from wcmc_tpu_torch.train.factory import TrainConfig as TConfig
from wcmc_tpu_torch.train.factory import init_interfaces as tinit

LOSS_TOL, GRAD_TOL, PARAM_TOL = 1e-5, 1e-4, 1e-6
LR = 1e-3
BASE = dict(base_model="kpcn", kpcn_ksize=5, finite_check_every=1, lr_dncnn=LR, lr_pnet=(LR,),
            compute_dtype="float32")
VARIANTS = {
    "ref": dict(kpcn_ref=True),
    "pre_a": dict(kpcn_pre=True, use_llpm_buf=True, manif_learn=True, manif_loss="FMSE"),
    "pre_b": dict(kpcn_pre=True, use_llpm_buf=True),
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _compiled_reference_init():
    """wcmc_tpu's interfaces built with their models' initializers
    compiled, one XLA program a model config (cached across the
    interfaces of this module), where the reference runs them op by op:
    the reference's weights come from its own initializers either way,
    in a fraction of the time."""
    from wcmc_tpu.train import factory as jfactory
    from wcmc_tpu.train.state import ModelState

    init = jax.jit(lambda module, key, sample: module.init(key, sample)["params"],
                   static_argnums=0)

    def init_model_state(module, sample_batch, tx, key=None):
        params = init(module, jax.random.PRNGKey(0) if key is None else key, sample_batch)
        return ModelState(params=params, opt_state=tx.init(params))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfactory, "init_model_state", init_model_state)
        yield


_JAX_PRE = {}


def _jax_interface(variant, cfg):
    """The reference's interface of ``variant``; the two pre phases share
    one build's models and states (the same seed), so the reference's
    (slow, eager) initialization runs once for both."""
    if variant == "ref":
        return jinit(JConfig(**cfg))[0]
    if "a" not in _JAX_PRE:
        _JAX_PRE["a"] = jinit(JConfig(**dict(BASE, **VARIANTS["pre_a"])))[0]
    a = _JAX_PRE["a"]
    if variant == "pre_a":
        return a
    lf = {k: v for k, v in a.loss_funcs.items() if k != "l_manif"}
    return type(a)(a.models, a.states, a.optims, lf, manif_learn=False, train_branches=True,
                   seed=cfg.get("seed", 0), finite_check_every=1)


def _pair(variant):
    cfg = dict(BASE, **VARIANTS[variant])
    jif = _jax_interface(variant, cfg)
    tif = tinit(TConfig(**cfg, seed=1), device="cpu")[0]
    for name, st in jif.states.items():
        convert.load_flax_params(tif.models[name], st.params)
    return jif, tif


def _batches(variant, seed=1):
    llpm = variant != "ref"
    jb = jsynth(np.random.default_rng(seed), "kpcn", batch_size=2, patch=48, spp=2,
                use_llpm_buf=llpm)
    tb = tsynth(np.random.default_rng(seed), "kpcn", batch_size=2, patch=48, spp=2,
                use_llpm_buf=llpm)
    return jb, tb


def _jax_loss_fn(jif):
    step = jif._make_train_step()
    fns = {c.cell_contents.__name__: c.cell_contents for c in step.__closure__
           if callable(c.cell_contents) and hasattr(c.cell_contents, "__name__")}
    return fns["loss_fn"]


def _jax_draws(key, p_shape):
    """wcmc_tpu's roll draws from ``key`` for a channel-major p-buffer."""
    n_patch, n_batch = tl.positions(p_shape, cmajor=True)
    out = {}
    for name, k in zip(("patch", "batch"), jax.random.split(key)):
        n = n_patch if name == "patch" else n_batch
        k1, k2 = jax.random.split(k)
        out[name] = (int(jax.random.randint(k1, (), 0, n)), int(jax.random.randint(k2, (), 1, n)))
    return out


def _close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= tol * max(np.max(np.abs(want)), 1e-30)


def _flat(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_step_f32(variant):
    """One step of each variant: loss dict, every model's gradient, the
    updated parameters of the models the step trains, and the frozen
    models' parameters unchanged bit for bit."""
    jif, tif = _pair(variant)
    jb, tb = _batches(variant)
    _, sub = jax.random.split(jif._key)
    draws = None
    if variant == "pre_a":
        kd, ks = jax.random.split(sub)
        shape = (2, 2, 3, 48, 48)   # the whole patch: phase (a) crops nothing
        draws = {"diffuse": _jax_draws(kd, shape), "specular": _jax_draws(ks, shape)}
    params = {n: jif.states[n].params for n in jif.states}
    # the reference's ref variant joins the targets in train_batch, before its step
    jin = jif._augment(jb) if variant == "ref" else jb
    jgrads, jloss = jax.jit(jax.grad(_jax_loss_fn(jif), has_aux=True))(params, jin, sub)
    tif.to_train_mode()
    tif.preprocess(tb)
    _build.reset_counts()
    tloss = tif.train_batch(tb, grad_hook_mode=True, draws=draws)
    assert not _build.launches
    assert set(tloss) == set(jloss)
    for k, v in jloss.items():
        assert abs(float(tloss[k]) - float(v)) <= LOSS_TOL * abs(float(v)), k
    for name, model in tif.models.items():
        for g, w in zip(_flat(convert.grads_to_flax(model)), _flat(jgrads[name])):
            _close(g, w, GRAD_TOL)
    trained = set(tif._trained_models())
    assert trained == {"ref": {"dncnn"}, "pre_a": {"backbone_diffuse", "backbone_specular"},
                       "pre_b": {"dncnn"}}[variant]
    before = {n: [p.detach().clone() for p in m.parameters()] for n, m in tif.models.items()}

    # the reference's update of the models its step trains, from its gradients
    jnew = jax.jit(lambda g, st: jif._apply_updates(g, st, sorted(trained)))(jgrads, jif.states)
    tif.preprocess(tb)
    tif.train_batch(tb, draws=draws)
    for name, model in tif.models.items():
        if name not in trained:
            assert all(torch.equal(p, q) for p, q in zip(model.parameters(), before[name])), name
            continue
        got = _flat(convert.to_flax(model))
        for g, w, jg in zip(got, _flat(jnew[name].params), _flat(jgrads[name])):
            jg = np.abs(jg)
            diff = np.abs(g - w)
            sure = (jg > 1e-4 * jg.max()) & (jg > 1e-5)
            assert diff[sure].max(initial=0.0) <= PARAM_TOL, name
            assert diff.max() <= 2 * LR + PARAM_TOL, name


def test_ref_convert_and_validation():
    """The ref dncnn's first layers are 37 channels wide on both sides and
    ``convert`` carries them both ways; validation joins the targets too."""
    jif, tif = _pair("ref")
    jp = jif.states["dncnn"].params
    assert sum(x.ndim == 4 and x.shape[2] == 34 + 3 for x in _flat(jp)) == 2   # a branch each
    assert tif.models["dncnn"].n_in == 34 + 3
    back = convert.to_flax(tif.models["dncnn"])
    for g, w in zip(_flat(back), _flat(jp)):
        np.testing.assert_array_equal(g, w)
    jb, tb = _batches("ref", seed=2)
    jif.to_eval_mode()
    tif.to_eval_mode()
    jrad, _ = jif.validate_batch(jb)
    trad, tp = tif.validate_batch(tb)
    assert tp is None
    _close(trad.numpy(), np.asarray(jrad), 1e-5)
    assert abs(float(tif.m_losses["m_val"]) - float(jif.m_losses["m_val"])) <= \
        1e-5 * abs(float(jif.m_losses["m_val"]))


def test_ref_refuses_the_path_buffer():
    with pytest.raises(ValueError, match="neither"):
        tinit(TConfig(**dict(BASE, kpcn_ref=True, use_llpm_buf=True)), device="cpu")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    build_synthetic_dataset(root, n_train=1, n_val=1, n_test=1, size=160, spp=2,
                            test_extra_parts=0, seed=4)
    for mode in ("train", "val"):
        offline_preprocess(root, mode=mode, spp=8, device="cpu")
    offline_preprocess(root, mode="test", spp=2, test_spps=(2,), device="cpu")
    return root


def _argv(corpus, save, name, *extra):
    return ["--single_gpu", "--batch_size", "4", "--patches_per_image", "1",
            "--data_dir", corpus, "--model_name", name, "--desc", "variants test",
            "--save", save, "--compute_dtype", "float32", "--device", "cpu",
            "--kpcn_ksize", "5", "--train_branches", "--num_epoch", "1", *extra]


def test_cli_kpcn_ref_trains_and_serves(corpus, tmp_path, monkeypatch):
    from wcmc_tpu_torch.train.interfaces import KPCNRefInterface

    save = str(tmp_path / "w")
    ifaces, params = train_kpcn.main(train_kpcn.parse_args(
        _argv(corpus, save, "KPCN_ref", "--kpcn_ref", "--val_epoch", "2")))
    assert type(ifaces[0]).__name__ == "KPCNRefInterface"
    assert [s["steps"] for s in params["epoch_stats"]] == [1]
    # served from the latest checkpoint (no validation ran, so no best one)
    os.replace(os.path.join(save, "latest_KPCN_ref.ckpt"), os.path.join(save, "KPCN_ref.ckpt"))
    ck = load_checkpoint(os.path.join(save, "KPCN_ref.ckpt"))
    assert ck["model"] == "KPCNInterface"
    calls = []
    real = KPCNRefInterface._augment
    monkeypatch.setattr(KPCNRefInterface, "_augment",
                        staticmethod(lambda b: calls.append(1) or real(b)))
    results, iface = ttm.main(ttm.parse_args([
        "--model_name", "KPCN_ref", "--save", save, "--data_dir", corpus, "--spps", "2",
        "--kpcn_ref", "--kpcn_ksize", "5", "--compute_dtype", "float32", "--device", "cpu",
        "--output_dir", str(tmp_path / "eval")]))
    assert type(iface).__name__ == "KPCNRefInterface" and calls
    for name, m in iface.models.items():
        for p, q in zip(m.parameters(), ifaces[0].models[name].parameters()):
            assert torch.equal(p, q)
    out = results[("scene0", 2)]["output"]
    assert np.isfinite(out["linear_RelMSE"]) and np.isfinite(out["gamma22_DSSIM"])


def test_cli_kpcn_pre_phase_a(corpus, tmp_path):
    """Phase (a) from the command line trains the backbones alone (the
    steps of both phases are held against the reference above)."""
    save = str(tmp_path / "w")
    ifaces, _ = train_kpcn.main(train_kpcn.parse_args(
        _argv(corpus, save, "KPCN_pre", "--kpcn_pre", "--use_llpm_buf", "--manif_learn",
              "--manif_loss", "FMSE", "--val_epoch", "2")))
    ck = load_checkpoint(os.path.join(save, "latest_KPCN_pre.ckpt"))
    assert ck["model"] == "KPCNPreInterface"
    fresh = tinit(TConfig(**dict(BASE, **VARIANTS["pre_a"])), device="cpu")[0]
    for name, m in ifaces[0].models.items():
        same = all(torch.equal(p, q) for p, q in zip(m.parameters(),
                                                     fresh.models[name].parameters()))
        assert same == (name == "dncnn"), name
