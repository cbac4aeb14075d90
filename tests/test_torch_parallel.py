"""The port's parallel modes over 4 gloo ranks on the CPU, against
wcmc_tpu's single-device runs.

One module-scoped pool of 4 spawned ranks (``parallel.launch.RankPool``,
a ``file://`` rendezvous in a temporary directory, so parallel test
workers never share a port) runs the rank-side tasks of
``parallel/dryrun.py``; the reference runs here, on the same numpy
inputs and weights (the port's seeded initial weights, carried by
``convert``).  All f32.

* Data parallel (``to_mesh``): one KPCN step, and one KPCN + FMSE step
  (non-local, the reference's draws for the global batch injected), over
  4 ranks with the global batch of 4, against the reference's
  single-device step from the same weights: every model's averaged
  gradient within 1e-4 of that model's max |g| of ``jax.grad`` of the
  reference's loss, element by element (at most 2.3e-6 seen; a sum over
  the ranks where a mean is due is off by 3 max |g|, and the manifold
  loss, whose cross-batch term the ranks gather, makes about a fifth to
  two fifths of each backbone tensor's gradient; Adam's first step,
  lr g / (|g| + eps), would show neither); losses within rtol 2e-4,
  updated parameters within rtol 1e-4, atol 1e-5 (``test_parallel.py``'s
  limits) wherever the reference's first Adam step moved them by 0.99 lr
  or more (|g| about 1e-6 or more), and within 2 lr everywhere: a first
  Adam step moves a parameter by lr |g| / (|g| + 1e-8), so where |g| is
  near Adam's eps the gradient's f32 error moves it, in the
  single-process port step alike; the replicas bit for bit equal
  (checksums); validation after the step returns the global radiance in
  batch order and ``m_val`` the global ``l_test`` (within rtol 1e-5 of
  rank 0's replica validated in one process).
* Halo-exchanged inference of KPCN over 4 bands (``test_parallel.py``'s
  shapes: 384 x 96, halo 24) against the unsharded forward's interior,
  rtol 1e-4, atol 1e-5.
* spp-sharded forwards: PathNet (2, 8, 16, 16, 36) within rtol 1e-5, atol
  1e-6; ``Multisteps(24, 5, 2, 16)`` and a small LayerNet within rtol 1e-4,
  atol 1e-5, every rank's image the same; the dual PathNet against its
  unsharded run.
* The dry run at 4, the sharding rules, the loaders' shards (each rank's
  the slice of the global batch, the ranks' draws in step), and two ranks
  of ``python -m wcmc_tpu_torch.train_kpcn --n_devices 2 --device cpu``.

The main process runs torch on two threads and each rank on one, so the
module stays cheap beside the other test workers.
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
from wcmc_tpu_torch import models as tm
from wcmc_tpu_torch.parallel import dryrun as dr
from wcmc_tpu_torch.parallel.halo import exchange_halo, make_spatial_inference
from wcmc_tpu_torch.parallel.launch import RankPool
from wcmc_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch
from wcmc_tpu_torch.parallel.sample import shard_samples

WORLD = 4
LR = 1e-4   # TrainConfig's learning rates
KPCN = dict(base_model="kpcn", kpcn_ksize=5, finite_check_every=1, compute_dtype="float32")
FMSE = dict(KPCN, use_llpm_buf=True, manif_learn=True, manif_loss="FMSE")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with RankPool(WORLD, "gloo", rendezvous_dir=str(tmp_path_factory.mktemp("rdv")),
                  threads=1) as p:
        yield p


@pytest.fixture(autouse=True, scope="module")
def _shape_only_reference_init():
    """wcmc_tpu's interfaces built without running their models'
    initializers (zeros of the shapes ``jax.eval_shape`` gives them):
    ``_jax_interface`` then loads the port's seeded initial weights, so
    both sides start from the same weights without the reference's
    init programs."""
    from wcmc_tpu.train import factory as jfactory
    from wcmc_tpu.train.state import ModelState

    def init_model_state(module, sample_batch, tx, key=None):
        shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), sample_batch)["params"]
        params = jax.tree_util.tree_map(lambda x: jax.numpy.zeros(x.shape, x.dtype), shapes)
        return ModelState(params=params, opt_state=tx.init(params))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfactory, "init_model_state", init_model_state)
        yield


def _like(ref, value):
    """``value`` as a jax array, where the reference's tree holds ``ref``
    (``tree_map`` raises on another tree, this on another shape)."""
    assert np.shape(value) == ref.shape, (np.shape(value), ref.shape)
    return jax.numpy.asarray(value)


def _jax_interface(cfg):
    """wcmc_tpu's interface of ``cfg`` holding the port's initial weights
    of ``cfg`` (and a fresh optimizer state of them)."""
    from wcmc_tpu.train.state import ModelState

    jif = jinit(JConfig(**cfg))[0]
    for name, model in dr._interface(cfg, None, "cpu").models.items():
        params = jax.tree_util.tree_map(_like, jif.states[name].params, convert.to_flax(model))
        jif.states[name] = ModelState(params=params,
                                      opt_state=jif.optims["optim_" + name].init(params))
    return jif


def _np_tree(tree):
    """A flax param tree as nested dicts of numpy arrays (what the ranks
    unpickle without flax)."""
    if hasattr(tree, "items"):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _np_batch(batch):
    return {k: np.array(v) for k, v in batch.items()}


def _jax_draws(key, p_shape):
    """wcmc_tpu's roll draws from ``key`` for a channel-major p-buffer."""
    n_patch, n_batch = tl.positions(p_shape, cmajor=True)
    out = {}
    for name, k in zip(("patch", "batch"), jax.random.split(key)):
        n = n_patch if name == "patch" else n_batch
        k1, k2 = jax.random.split(k)
        out[name] = (int(jax.random.randint(k1, (), 0, n)), int(jax.random.randint(k2, (), 1, n)))
    return out


def _jax_loss_fn(jif):
    """The ``loss_fn(params, batch, key)`` of the reference's train step."""
    step = jif._make_train_step()
    fns = {c.cell_contents.__name__: c.cell_contents for c in step.__closure__
           if callable(c.cell_contents) and hasattr(c.cell_contents, "__name__")}
    return fns["loss_fn"]


def _dp_run(pool, jif, cfg):
    """The reference's single-device step (its gradients, then its update
    of them) and the port's 4-rank step and validation, from the same
    weights, batch and draws."""
    batch = jsynth(np.random.default_rng(1), "kpcn", batch_size=WORLD, patch=48, spp=2,
                   use_llpm_buf=cfg.get("use_llpm_buf", False))
    key = jax.random.PRNGKey(7)
    params = {n: _np_tree(st.params) for n, st in jif.states.items()}
    draws = None
    if cfg.get("manif_learn"):
        kd, ks = jax.random.split(key)
        shape = (WORLD, 2, 3, 8, 8)   # the global batch's cropped p-buffer
        draws = {"diffuse": _jax_draws(kd, shape), "specular": _jax_draws(ks, shape)}
    jparams = {n: st.params for n, st in jif.states.items()}
    jgrads, loss = jax.jit(jax.grad(_jax_loss_fn(jif), has_aux=True))(jparams, batch, key)
    states = jax.jit(lambda g, st: jif._apply_updates(g, st, list(jif.models)))(
        jgrads, jif.states)
    ranks = pool.run(dr.dp_step, dict(cfg, seed=1), _np_batch(batch), params, draws, 1, None,
                     True, True)
    # the reference's gradients in the port's parameter order: loaded as
    # the parameters of a model of the same config
    gif = dr._interface(cfg, {n: _np_tree(g) for n, g in jgrads.items()}, "cpu")
    want = {"loss": {k: float(v) for k, v in loss.items()}, "before": params,
            "params": {n: _np_tree(st.params) for n, st in states.items()},
            "grads": {n: [p.detach().double().numpy().reshape(-1) for p in m.parameters()]
                      for n, m in gif.models.items()}}
    # the validation of rank 0's replica in one process
    tif = dr._interface(cfg, ranks[0]["params"], "cpu")
    tif.to_eval_mode()
    radiance, _ = tif.validate_batch(_np_batch(batch))
    want.update(radiance=radiance.numpy(), l_test=float(tif.m_losses["m_val"]))
    return want, ranks


@pytest.fixture(scope="module")
def jax_kpcn():
    return _jax_interface(KPCN)


@pytest.fixture(scope="module")
def dp_kpcn(pool, jax_kpcn):
    return _dp_run(pool, jax_kpcn, KPCN)


@pytest.fixture(scope="module")
def dp_fmse(pool):
    return _dp_run(pool, _jax_interface(FMSE), FMSE)


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("run", ["dp_kpcn", "dp_fmse"])
def test_dp_step_matches_single_device(run, request):
    want, ranks = request.getfixturevalue(run)
    got = ranks[0]["losses"][0]
    assert set(got) == set(want["loss"])
    for k, v in want["loss"].items():
        np.testing.assert_allclose(got[k], v, rtol=2e-4, atol=1e-6, err_msg=k)
    assert set(ranks[0]["params"]) == set(want["params"])
    for name, tree in want["params"].items():
        for g, w, w0 in zip(_leaves(ranks[0]["params"][name]), _leaves(tree),
                            _leaves(want["before"][name])):
            # where the reference's first Adam step moved a parameter by
            # (nearly) the full lr, its |g| is clear of Adam's eps; below
            # that the move is lr |g| / (|g| + 1e-8) and the gradients' own
            # f32 error moves it (as for the single-process port step)
            full = np.abs(w - w0) >= 0.99 * LR
            np.testing.assert_allclose(g[full], w[full], rtol=1e-4, atol=1e-5, err_msg=name)
            assert np.abs(g - w).max() <= 2 * LR + 1e-5, name


@pytest.mark.parametrize("run", ["dp_kpcn", "dp_fmse"])
def test_dp_gradients_match_jax_grad(run, request):
    """The gradients every rank's optimizer sees: the average over the
    ranks of each shard's, the global loss's gradients (the FMSE
    cross-batch term over the gathered batch)."""
    want, ranks = request.getfixturevalue(run)
    for r in ranks:
        for name in want["grads"]:
            np.testing.assert_array_equal(r["grads"][name], ranks[0]["grads"][name])
    for name, tensors in want["grads"].items():
        got, w = ranks[0]["grads"][name], np.concatenate(tensors)
        assert got.shape == w.shape, name
        assert np.abs(got - w).max() <= 1e-4 * np.abs(w).max(), name


@pytest.mark.parametrize("run", ["dp_kpcn", "dp_fmse"])
def test_dp_replicas_bit_identical(run, request):
    _, ranks = request.getfixturevalue(run)
    assert len({r["checksum"] for r in ranks}) == 1
    assert all(r["losses"] == ranks[0]["losses"] for r in ranks)


@pytest.mark.parametrize("run", ["dp_kpcn", "dp_fmse"])
def test_to_mesh_validation_is_global(run, request):
    want, ranks = request.getfixturevalue(run)
    for r in ranks:
        assert r["radiance"].shape == want["radiance"].shape   # the global batch, on every rank
        np.testing.assert_array_equal(r["radiance"], ranks[0]["radiance"])
        assert r["m_val"] == ranks[0]["m_val"]
    # the global batch's radiance in batch order: each shard's forward is
    # the whole batch's, element by element
    np.testing.assert_allclose(ranks[0]["radiance"], want["radiance"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ranks[0]["m_val"], want["l_test"], rtol=1e-5)


def test_halo_inference_matches_single_device(pool, jax_kpcn):
    model, params = jax_kpcn.models["dncnn"], jax_kpcn.states["dncnn"].params
    batch = jsynth(np.random.default_rng(2), "kpcn", batch_size=1, patch=96, spp=2)
    frame = {k: np.concatenate([np.asarray(v)] * 4, axis=1) for k, v in batch.items()
             if k.startswith("kpcn_")}
    ranks = pool.run(dr.halo_forward, dict(KPCN), frame, 24, {"dncnn": _np_tree(params)})
    out = np.concatenate([r["band"] for r in ranks], axis=1)
    full = np.asarray(jax.jit(model.apply)({"params": params}, frame)["radiance"])
    h, w = frame["kpcn_albedo"].shape[1:3]
    assert out.shape == (1, h, w, 3)
    r = model.shrink // 2
    np.testing.assert_allclose(out[:, r:h - r, r:w - r], full, rtol=1e-4, atol=1e-5)


def _jax_model(model, spec, batch):
    """The port's model of ``spec`` with seeded weights: its parameters
    (flax layout) and the reference ``model``'s forward of ``batch`` with
    them."""
    kw = {k: v for k, v in spec.items() if k != "kind"}
    ctor = {"pathnet": tm.PathNet, "layernet": tm.LayerNet, "multisteps": tm.Multisteps}
    params = convert.to_flax(ctor[spec["kind"]](**kw, generator=torch.Generator().manual_seed(0)))
    return params, np.asarray(jax.jit(model.apply)({"params": params}, batch))


def test_sample_parallel_pathnet_matches_single_device(pool):
    from wcmc_tpu.models import PathNet

    rng = np.random.default_rng(3)
    batch = {"paths": rng.standard_normal((2, 8, 16, 16, 36)).astype(np.float32)}
    spec = {"kind": "pathnet", "ic": 36, "outc": 3}
    params, want = _jax_model(PathNet(ic=36, outc=3), spec, batch)
    ranks = pool.run(dr.sample_forward, spec, params, batch)
    out = np.concatenate([r["out"] for r in ranks], axis=1)   # each rank its 2 samples
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["multisteps", "layernet"])
def test_sample_parallel_image_models_match_single_device(pool, kind):
    from wcmc_tpu.models import LayerNet, Multisteps

    rng = np.random.default_rng(4)
    n_in = 24 if kind == "multisteps" else 8
    batch = {"radiance": rng.random((1, 4, 16, 16, 3)).astype(np.float32),
             "features": rng.standard_normal((1, 4, 16, 16, n_in)).astype(np.float32)}
    if kind == "multisteps":
        spec = dict(kind=kind, n_in=n_in, ksize=5, n_steps=2, width=16)
        jmodel = Multisteps(n_in=n_in, ksize=5, n_steps=2, width=16)
    else:
        spec = dict(kind=kind, n_in=n_in, ksize=5, width=16, embed_width=8)
        jmodel = LayerNet(n_in=n_in, ksize=5, width=16, embed_width=8)
    params, want = _jax_model(jmodel, spec, batch)
    ranks = pool.run(dr.sample_forward, spec, params, batch)
    for r in ranks:
        np.testing.assert_array_equal(r["out"], ranks[0]["out"])
    np.testing.assert_allclose(ranks[0]["out"], want, rtol=1e-4, atol=1e-5)


def test_sample_parallel_dual_pathnet(pool):
    """KPCN's dual PathNet: each rank's samples of the unsharded run, and
    its moments the sums over its own samples."""
    from wcmc_tpu_torch.models import PathNet
    from wcmc_tpu_torch.models.pathnet import dual_pathnet_apply

    gen = torch.Generator().manual_seed(5)
    d, s = PathNet(generator=gen), PathNet(generator=gen)
    paths = np.random.default_rng(5).standard_normal((1, 8, 16, 16, 36)).astype(np.float32)
    params = {"diffuse": convert.to_flax(d), "specular": convert.to_flax(s)}
    ranks = pool.run(dr.sample_forward, {"kind": "dual_pathnet"}, params, {"paths": paths})
    with torch.no_grad():
        p_d, p_s, (ssum, _) = dual_pathnet_apply(d, s, {"paths": torch.from_numpy(paths)},
                                                 with_moments=True)
    np.testing.assert_allclose(np.concatenate([r["diffuse"] for r in ranks], 1), p_d.numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.concatenate([r["specular"] for r in ranks], 1), p_s.numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sum(r["ssum"] for r in ranks), ssum.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_dryrun_at_4(pool):
    report = dr.dryrun(WORLD, pool=pool)
    assert report["halo_max_err"] <= 1e-4 and report["sample_max_err"] <= 1e-5


def test_sharding_rules():
    """Uneven shards raise, as the reference's sharding does; a mesh needs
    a process group; the halo must cover the shrink."""
    mesh = Mesh(n_data=4, n_spatial=1, rank=1, device=torch.device("cpu"), data_group=None,
                spatial_group=None)
    x = np.arange(8 * 3).reshape(8, 3)
    np.testing.assert_array_equal(shard_batch({"x": x}, mesh)["x"], x[2:4])
    with pytest.raises(ValueError, match="does not split"):
        shard_batch({"x": x[:6]}, mesh)
    sp = Mesh(n_data=1, n_spatial=4, rank=3, device=torch.device("cpu"), data_group=None,
              spatial_group=None)
    paths = np.zeros((1, 8, 2, 2, 1))
    assert shard_samples({"paths": paths}, sp)["paths"].shape[1] == 2
    with pytest.raises(ValueError, match="evenly"):
        shard_samples({"paths": paths[:, :6]}, sp)
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(2)
    with pytest.raises(ValueError, match="halo"):
        make_spatial_inference(lambda b: b, sp, shrink=56, halo=24)
    band = torch.ones(1, 6, 2, 1)
    padded = exchange_halo(band, None, 1, 2)   # one rank: zero halos
    assert padded.shape == (1, 10, 2, 1) and padded[:, :2].abs().sum() == 0


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from wcmc_tpu_torch.data.dataset import offline_preprocess
    from wcmc_tpu_torch.data.synthetic import build_synthetic_dataset

    root = str(tmp_path_factory.mktemp("corpus"))
    build_synthetic_dataset(root, n_train=1, n_val=1, n_test=1, size=160, spp=2,
                            test_extra_parts=0, seed=4)
    for mode in ("train", "val"):
        offline_preprocess(root, mode=mode, spp=8, device="cpu")
    return root


@pytest.mark.parametrize("mode", ["train", "val"])
def test_loader_shards_make_the_global_batch(corpus, mode):
    """A rank's loader (``shard``) serves its slice of each global batch:
    the ranks' shards, joined in rank order, are the unsharded loader's
    batches, so the ranks draw in step; a batch the ranks do not divide
    raises."""
    from wcmc_tpu_torch.data.dataset import BatchLoader, MSDenoiseDataset, ShuffleLoader

    def loader(shard, batch_size=4):
        ds = MSDenoiseDataset(corpus, 8, "kpcn", mode, batch_size,
                              "random" if mode == "train" else "grid", use_sbmc_buf=False,
                              patches_per_image=batch_size, seed=3)
        if mode == "train":
            return ShuffleLoader(ds, batch_size, seed=3, shard=shard)
        return BatchLoader(ds, batch_size, shard=shard)

    whole = list(loader((0, 1)))
    parts = [list(loader((r, 2))) for r in range(2)]
    assert whole and all(len(p) == len(whole) for p in parts)
    for i, batch in enumerate(whole):
        for k, v in batch.items():
            assert parts[0][i][k].shape[0] == v.shape[0] // 2
            np.testing.assert_array_equal(np.concatenate([p[i][k] for p in parts]), v)
    with pytest.raises(ValueError, match="does not split"):
        list(loader((0, 3), batch_size=4))


def test_cli_n_devices_2(corpus, tmp_path, monkeypatch):
    """Two gloo ranks of the KPCN entry point for one step; rank 0 alone
    writes the checkpoint."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    save = str(tmp_path / "w")
    ifaces, summary = train_kpcn.main(train_kpcn.parse_args([
        "--single_gpu", "--batch_size", "4", "--patches_per_image", "1", "--data_dir", corpus,
        "--model_name", "KPCN_dp", "--desc", "two ranks", "--save", save, "--compute_dtype",
        "float32", "--device", "cpu", "--kpcn_ksize", "5", "--train_branches", "--num_epoch",
        "1", "--val_epoch", "2", "--n_devices", "2"]))
    assert ifaces is None and [e["steps"] for e in summary["epoch_stats"]] == [1]
    assert os.listdir(save) == ["latest_KPCN_dp.ckpt"]


def test_cli_n_devices_needs_the_cards():
    """More ranks than visible cards raises before anything starts (no
    card here)."""
    with pytest.raises(ValueError, match="needs 2 cards"):
        train_kpcn.main(train_kpcn.parse_args([
            "--single_gpu", "--desc", "x", "--device", "cuda", "--n_devices", "2"]))
