"""The port's SBMC Multisteps, its kernel forms and its train step against
wcmc_tpu's.

* The SBMC forms of the PathNet-shaped MLPs (plain versions of kernels
  K4-fwd and K5-fwd): the embedding with leaky relu on every layer from a
  ragged input width (95), and the update head [C | C] -> C -> C with
  leaky relu, a bf16 output and moments.  f32 against ``_embed_xla`` /
  ``_head_xla``: within 1e-5 of max |ref|.  bf16 against the Pallas
  kernels in interpret mode: within 2e-2 of max |ref| (a bf16 hidden
  layer summed in another order can round to a neighbouring value).  The
  moments are summed from the unrounded f32 output, as the Pallas kernel
  sums them (``_head_xla`` sums the output after its rounding to bf16;
  the port follows the kernel).
* ``Multisteps`` in f32 (width 16, 2 steps, K = 5, 16 px, 2 spp) for
  n_in 24 and 95 with both splat weightings, from parameters carried by
  ``convert``: the output within 1e-4 of max |ref| (measured at most
  3.8e-6) and every parameter gradient within 2e-4 of its max |ref|
  (measured at most 1.1e-5; f32 summed in another order through the
  U-Nets, the MLPs and the splat).
* ``Multisteps`` in bf16 against wcmc_tpu in bf16 with its Pallas
  kernels (K4, K5, the splat) in interpret mode: measured 1.7e-2 of max
  |ref| on this seed (1.7e-2 to 3.7e-2 over seeds 0-2; wcmc_tpu's own XLA
  and Pallas paths differ by 1.9e-2 to 3.0e-2 on the same seeds: bf16
  roundings in 12 U-Net convolutions and 7 MLP layers move the logits,
  and the standardization's gain of 10 amplifies them before ``exp``);
  held to 4e-2, about 2.5x.
* One full f32 step of the SBMC configuration that ``train_sbmc.py
  --use_llpm_buf --manif_learn --manif_loss FMSE`` builds (Multisteps at
  full width 128 and 3 steps, K = 5, with the single PathNet; FMSE with
  roll pairing, w_manif 0.1, Adam with global-norm clip 1000) from the
  same parameters, batch (one patch of 16 px at 2 spp) and draws (the
  reference's key, replayed): the loss dict within 1e-5 relative and each
  gradient tensor within 2e-4 of its max |g| (measured 7.3e-7 and
  2.7e-5).  The batch seed is one on which no leaky-relu pre-activation
  of either side lies within rounding of zero: the three U-Nets of width
  128 to 512 hold about 10^6 pre-activations per 16-px patch, and where
  one lies at a tie the two frameworks take its two slopes and the
  gradients below it move by up to 14% of their max (seeds 0-6 of this
  batch; at 2 patches of 32 px no seed of 0-5 is free of ties).
  ``validate_batch`` (2 patches of 32 px) within 1e-5 of max |ref|.
* Tiled inference of a 128x128 4-spp synthetic scene (2 samples cached
  plus an extra-spp part, SBMC caches written by the port) through the
  port's ``test_models.main`` with an SBMC name, reading a checkpoint that
  wcmc_tpu wrote, against wcmc_tpu's ``denoise``: the metric grid within
  1e-4 relative.
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wcmc_tpu import evaluate as jev
from wcmc_tpu.data.batches import synthetic_batch as jsynth
from wcmc_tpu.models.sbmc import Multisteps as JMultisteps
from wcmc_tpu.train.checkpoint import save_checkpoint
from wcmc_tpu.train.factory import TrainConfig as JConfig
from wcmc_tpu.train.factory import init_interfaces as jinit
from wcmc_tpu_torch import convert
from wcmc_tpu_torch import losses as tl
from wcmc_tpu_torch import test_models as ttm
from wcmc_tpu_torch.data.batches import synthetic_batch as tsynth
from wcmc_tpu_torch.data.dataset import offline_preprocess
from wcmc_tpu_torch.data.synthetic import build_synthetic_dataset
from wcmc_tpu_torch.models.sbmc import Multisteps as TMultisteps
from wcmc_tpu_torch.ops import _build
from wcmc_tpu_torch.ops import pathnet_fused as tpf
from wcmc_tpu_torch.train.factory import TrainConfig as TConfig
from wcmc_tpu_torch.train.factory import init_interfaces as tinit

jpf = importlib.import_module("wcmc_tpu.ops.pathnet_fused")
jmf = importlib.import_module("wcmc_tpu.ops.mlp_fused")
jpk = importlib.import_module("wcmc_tpu.ops.pallas_kernels")

F32_TOL, BF16_TOL = 1e-5, 2e-2
OUT_TOL, GRAD_TOL = 1e-4, 2e-4
LEAKY = ("leaky_relu",) * 3
K = 5


def _close(got, want, tol):
    got = np.asarray(torch.as_tensor(got).detach().float(), np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= tol * max(np.max(np.abs(want)), 1e-30)


def _pallas(fn, *args, **kw):
    jpk.INTERPRET, jmf.FORCE_PALLAS = True, True
    try:
        return fn(*args, **kw)
    finally:
        jpk.INTERPRET, jmf.FORCE_PALLAS = False, False


def _params(rng, dims):
    ws = [(rng.standard_normal((ci, co)) / np.sqrt(ci)).astype(np.float32)
          for ci, co in zip(dims[:-1], dims[1:])]
    bs = [(0.1 * rng.standard_normal(co)).astype(np.float32) for co in dims[1:]]
    return ws, bs


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


# ---------------------------------------------------------------------------
# the SBMC forms of K4-fwd and K5-fwd
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mlp_case():
    rng = np.random.default_rng(11)
    b, s, hw, c = 2, 3, 40, 32
    x = rng.standard_normal((b, s, hw, 95)).astype(np.float32)
    e = rng.standard_normal((b, s, hw, c)).astype(np.float32)
    ctx = rng.standard_normal((b, hw, c)).astype(np.float32)
    return x, _params(rng, (95, c, c, c)), e, ctx, _params(rng, (2 * c, c, c))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_leaky_embed(mlp_case, dtype):
    x, (ws, bs), *_ = mlp_case
    if dtype == "float32":
        want = jpf._embed_xla(jnp.asarray(x), _j(ws), _j(bs), LEAKY)
        tol = F32_TOL
    else:
        want = _pallas(jpf.pathnet_embed, jnp.asarray(x, jnp.bfloat16), _j(ws), _j(bs), LEAKY)
        tol = BF16_TOL
    got = tpf.pathnet_embed(torch.from_numpy(x).to(getattr(torch, dtype)), _t(ws), _t(bs),
                            LEAKY, compute_dx=True)
    assert got[0].dtype == getattr(torch, dtype) and got[1].dtype == torch.float32
    for g, w in zip(got, want):
        _close(g, w, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("moments", [False, True])
def test_wide_head(mlp_case, dtype, moments):
    """[32 | 32] -> 32 -> 32, leaky relu, output in the compute dtype."""
    *_, e, ctx, (ws, bs) = mlp_case
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    args = (jnp.asarray(e, jdt), jnp.asarray(ctx), _j(ws), _j(bs), LEAKY[:2], moments, jdt)
    if dtype == "float32":
        want, tol = jpf._head_xla(*args), F32_TOL
    else:
        want, tol = _pallas(jpf.pathnet_head, *args), BF16_TOL
    got = tpf.pathnet_head(torch.from_numpy(e).to(tdt), torch.from_numpy(ctx), _t(ws), _t(bs),
                           LEAKY[:2], moments, out_dtype=tdt)
    if not moments:
        got, want = (got,), (want,)
    assert got[0].dtype == tdt and got[0].shape == e.shape
    assert all(m.dtype == torch.float32 for m in got[1:])
    for g, w in zip(got, want):
        _close(g, w, tol)


# ---------------------------------------------------------------------------
# Multisteps
# ---------------------------------------------------------------------------

def _model_pair(n_in, splat, dtype=None, seed=0, b=2, s=2, p=16):
    rng = np.random.default_rng(seed)
    batch = {"radiance": (2.0 * rng.random((b, s, p, p, 3))).astype(np.float32),
             "features": rng.standard_normal((b, s, p, p, n_in)).astype(np.float32)}
    kw = dict(n_in=n_in, ksize=K, n_steps=2, width=16, splat_weighting=splat)
    jm = JMultisteps(**kw, dtype=dtype)
    params = jm.init(jax.random.PRNGKey(seed), {k: jnp.asarray(v) for k, v in batch.items()})
    tm = TMultisteps(**kw, dtype=None if dtype is None else torch.bfloat16)
    convert.load_flax_params(tm, params["params"])
    return batch, jm, params["params"], tm


@pytest.mark.parametrize("splat", ["exp", "softmax"])
@pytest.mark.parametrize("n_in", [24, 95])
def test_multisteps_f32(n_in, splat):
    batch, jm, params, tm = _model_pair(n_in, splat)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    g = np.random.default_rng(7).standard_normal((2, 16, 16, 3)).astype(np.float32)
    y_j, vjp = jax.vjp(lambda p: jm.apply({"params": p}, jb), params)
    grads_j = vjp(jnp.asarray(g))[0]
    _build.reset_counts()
    y = tm({k: torch.from_numpy(v) for k, v in batch.items()})
    y.backward(torch.from_numpy(g))
    assert not _build.launches
    assert _build.plain_calls["pathnet_embed"] == 1 and _build.plain_calls["pathnet_head"] == 2
    assert _build.plain_calls["scatter"] == 1 and _build.plain_calls["outer"] == 1
    assert y.dtype == torch.float32 and y.shape == (2, 16, 16, 3)
    _close(y, y_j, OUT_TOL)
    got = jax.tree_util.tree_leaves_with_path(convert.grads_to_flax(tm))
    want = jax.tree_util.tree_leaves_with_path(grads_j)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, a), (_, b) in zip(got, want):
        _close(a, b, GRAD_TOL)


def test_multisteps_bf16_against_pallas():
    batch, jm, params, tm = _model_pair(95, "exp", jnp.bfloat16)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    y_j = _pallas(jm.apply, {"params": params}, jb)
    with torch.no_grad():
        y = tm({k: torch.from_numpy(v) for k, v in batch.items()})
    assert y.dtype == torch.float32
    _close(y, y_j, 4e-2)


def test_multisteps_convert_round_trip_and_checks():
    batch, _, params, tm = _model_pair(24, "exp", seed=3)
    back = jax.tree_util.tree_leaves_with_path(convert.to_flax(tm))
    want = jax.tree_util.tree_leaves_with_path(params)
    assert [p for p, _ in back] == [p for p, _ in want]
    for (_, a), (_, b) in zip(back, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert {p[0].key for p, _ in want} == (
        {f"embedding_{k}{i}" for k in "wb" for i in range(3)}
        | {f"update_{s}_{k}{i}" for s in range(2) for k in "wb" for i in range(2)}
        | {"propagation_0", "propagation_1", "kernel_head"})
    assert str(tm) == "Multisteps i24 k5 s2 w16"
    bad = {k: torch.from_numpy(v) for k, v in batch.items()}
    bad["features"] = bad["features"][..., :-1]
    with pytest.raises(ValueError):
        tm(bad)


# ---------------------------------------------------------------------------
# the SBMC + manifold train step, validation and tiled inference
# ---------------------------------------------------------------------------

LR = 1e-3
BATCH_SEED = 7
CFG = dict(base_model="sbmc", sbmc_ksize=K, use_llpm_buf=True, manif_learn=True,
           manif_loss="FMSE", finite_check_every=1, lr_dncnn=LR, lr_pnet=(LR,),
           compute_dtype="float32")


@pytest.fixture(scope="module")
def pair():
    jif = jinit(JConfig(**CFG))[0]
    tif = tinit(TConfig(**CFG, seed=1), device="cpu")[0]
    assert str(tif) == "SBMCInterface" and set(tif.models) == set(jif.states)
    assert str(tif.models["dncnn"]) == "Multisteps i95 k5 s3 w128"
    for name, st in jif.states.items():
        convert.load_flax_params(tif.models[name], st.params)
    return jif, tif


def _batches(seed, b=2, patch=32, spp=2):
    """The same synthetic batch built by each package from one seed."""
    jb = jsynth(np.random.default_rng(seed), "sbmc", batch_size=b, patch=patch, spp=spp,
                use_llpm_buf=True)
    tb = tsynth(np.random.default_rng(seed), "sbmc", batch_size=b, patch=patch, spp=spp,
                use_llpm_buf=True)
    assert set(jb) == set(tb) == {"radiance", "features", "target_image", "paths"}
    assert tb["features"].shape[-1] == 91
    for k in jb:
        want = np.asarray(jb[k])
        np.testing.assert_allclose(tb[k].numpy(), want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max())
    return jb, tb


def _jax_draws(key, p_shape):
    """The roll draws of wcmc_tpu's manifold loss from ``key`` for a
    channels-last (B,S,H,W,C) p-buffer."""
    n_patch, n_batch = tl.positions(p_shape)
    out = {}
    for name, k, n in zip(("patch", "batch"), jax.random.split(key), (n_patch, n_batch)):
        k1, k2 = jax.random.split(k)
        out[name] = (int(jax.random.randint(k1, (), 0, n)), int(jax.random.randint(k2, (), 1, n)))
    return out


def _jax_loss_fn(jif):
    step = jif._make_train_step()
    fns = {c.cell_contents.__name__: c.cell_contents for c in step.__closure__
           if callable(c.cell_contents) and hasattr(c.cell_contents, "__name__")}
    return fns["loss_fn"]


def test_sbmc_train_step_f32(pair):
    jif, tif = pair
    jb, tb = _batches(BATCH_SEED, b=1, patch=16)
    _, sub = jax.random.split(jif._key)
    b, s, h, w = jb["radiance"].shape[:4]
    draws = _jax_draws(sub, (b, s, h, w, tif.models["backbone"].outc))
    params = {n: jif.states[n].params for n in jif.states}
    jgrads, jloss = jax.jit(jax.grad(_jax_loss_fn(jif), has_aux=True))(params, jb, sub)
    tif.to_train_mode()
    tif.preprocess(tb)
    _build.reset_counts()
    tloss = tif.train_batch(tb, grad_hook_mode=True, draws=draws)
    assert not _build.launches
    assert set(tloss) == set(jloss) == {"l_manif", "l_recon", "l_total", "rmse"}
    for k, v in jloss.items():
        assert abs(float(tloss[k]) - float(v)) <= F32_TOL * abs(float(v)), k
    for name, model in tif.models.items():
        got = jax.tree_util.tree_leaves_with_path(convert.grads_to_flax(model))
        want = jax.tree_util.tree_leaves_with_path(jgrads[name])
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, g), (_, wv) in zip(got, want):
            _close(g, wv, GRAD_TOL)


def test_sbmc_validate_batch(pair):
    jif, tif = pair
    jb, tb = _batches(2)
    jif.to_eval_mode()
    tif.to_eval_mode()
    tif.preprocess(tb)
    jrad, jp = jif.validate_batch(jb)
    trad, tp = tif.validate_batch(tb)
    _close(trad, jrad, F32_TOL)
    assert tp.shape == (2, 2, 32, 32, 3)
    _close(tp, jp, F32_TOL)


def test_sbmc_tiled_inference_through_test_models(pair, tmp_path):
    jif, _ = pair
    root = str(tmp_path / "data")
    build_synthetic_dataset(root, n_train=0, n_val=0, n_test=1, size=128, spp=2,
                            test_extra_parts=1, seed=12)
    offline_preprocess(root, mode="test", spp=2, sbmc=True, kpcn=False, device="cpu")
    save_checkpoint(str(tmp_path / "SBMC_ckpt.ckpt"), jif, epoch=0)
    input_dir = os.path.join(root, "test", "input")
    args = ttm.parse_args(["--model_name", "SBMC_ckpt", "--save", str(tmp_path),
                           "--data_dir", root, "--spps", "4", "--use_llpm_buf",
                           "--use_sbmc_buf", "--sbmc_ksize", str(K),
                           "--compute_dtype", "float32", "--device", "cpu",
                           "--output_dir", str(tmp_path / "t")])
    _build.reset_counts()
    results, cli_if = ttm.main(args)
    assert str(cli_if) == "SBMCInterface" and not _build.launches
    assert dict(_build.plain_calls) == {"pathnet_embed": 2, "pathnet_head": 4, "scatter": 1}
    jres = jev.denoise(jif, input_dir, "sbmc", spps=(4,), use_llpm_buf=True,
                       output_dir=str(tmp_path / "j"))
    got, want = results[("scene0", 4)], jres[("scene0", 4)]
    for which in ("output", "input"):
        for k, v in want[which].items():
            if k != "inference_sec":
                np.testing.assert_allclose(got[which][k], v, rtol=1e-4, atol=1e-7)
