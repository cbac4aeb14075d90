"""What surrounds the f32 bodies of K10 (``csrc/mlp_f32.cu``), on the CPU
(the kernels run only on the card: ``tests/test_torch_kernels_gpu.py``).

* ``mlp_f32_plan``: the shared-memory carve in the kernels' order (the
  weights, biases and, backward, their transposes, then 32-row f32 tiles),
  the blocks resident an SM and the grid at LBMC's 1,048,576 rows on 132
  SMs, for LayerNet's 32 -> 32^3 chain and the corners of what
  ``_check_form`` admits, and its refusals.
* ``_mlp_f32_walk`` and ``_mlp_bwd_f32_walk``, the f32 bodies' order (each
  output a fused multiply-add chain from zero, the weight gradients chained
  over each block's rows from its partial, the partials summed in block
  order), against the plain f32 versions at 300 ragged rows: within 1e-5 of
  max |ref| (the same f32 math summed in another order).
* The routing of ``_mlp_fwd_kernel`` / ``_mlp_bwd_kernel`` on card tensors
  by dtype: f32 to the f32 entry points in every form (LayerNet's backward
  to the tensor-core body, ``body="simt"`` to the SIMT one), bf16 to the
  bodies it ran on before, and a TypeError for any other dtype.  The launch is
  intercepted at the kernel lookup (``_build.kernel``), which names the C
  entry point; nothing runs.
* The port's LBMC f32 forward (LayerNet, its PixelMLP embedding on K10's
  f32 route) and PixelMLP's f32 backward against wcmc_tpu's f32 Pallas
  chain in interpret mode (``FORCE_PALLAS``), at 432 and 300 ragged rows:
  within 1e-5 of max |ref|.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wcmc_tpu.models.blocks import PixelMLP as JPixelMLP
from wcmc_tpu.models.lbmc import LayerNet as JLayerNet
from wcmc_tpu_torch import convert
from wcmc_tpu_torch.models.blocks import PixelMLP as TPixelMLP
from wcmc_tpu_torch.models.lbmc import LayerNet as TLayerNet
from wcmc_tpu_torch.ops import _build
from wcmc_tpu_torch.ops import mlp_fused as mf
from wcmc_tpu_torch.ops.conv5 import SMEM_LIMIT

jmf = importlib.import_module("wcmc_tpu.ops.mlp_fused")
jpk = importlib.import_module("wcmc_tpu.ops.pallas_kernels")

TOL = 1e-5
LEAKY3 = ("leaky_relu",) * 3
FORMS = {
    "layernet": (32, (32, 32, 32), LEAKY3),
    "mixed": (27, (16, 48, 32), ("relu", "leaky_relu", "linear")),
    "wide4": (64, (64, 64, 64, 64), ("relu", "leaky_relu", "relu", "linear")),
    "one": (5, (16,), ("leaky_relu",)),
}


def _tile(c):
    return -(-4 * 32 * c // 128) * 128


def _r128(n):
    return -(-n // 128) * 128


@pytest.mark.parametrize("form", list(FORMS))
def test_mlp_f32_plan(form):
    """Forward: weights, biases, x and up to two hidden tiles as wide as the
    widest hidden layer; backward: weights, biases, transposes, x, each
    hidden layer and the cotangent; 32 f32 rows a tile; up to 4 blocks an
    SM, 528 blocks over LBMC's 32,768 tiles on 132 SMs."""
    c0, widths, acts = FORMS[form]
    dims = (c0, *widths)
    weights = sum(ci * co for ci, co in zip(dims[:-1], dims[1:]))
    fwd = mf.mlp_f32_plan(c0, widths, acts)
    hidden = max(dims[1:-1], default=0)
    n_hidden = min(len(widths) - 1, 2)
    want = [_r128(4 * weights), _r128(4 * sum(widths)), _tile(c0)] + [_tile(hidden)] * n_hidden
    assert [m for _, m in fwd.smem] == want and fwd.total == sum(want)
    assert [n for n, _ in fwd.smem][:3] == ["weights", "bias", "x"]
    bwd = mf.mlp_f32_plan(c0, widths, acts, bwd=True)
    want = ([_r128(4 * weights), _r128(4 * sum(widths)), _r128(4 * weights), _tile(c0)]
            + [_tile(c) for c in widths[:-1]] + [_tile(widths[-1])])
    assert [m for _, m in bwd.smem] == want and bwd.total == sum(want) <= SMEM_LIMIT
    assert [n for n, _ in bwd.smem][:4] == ["weights", "bias", "transposes", "x"]
    assert bwd.smem[-1][0] == "g" and bwd.parts == fwd.parts == weights + sum(widths)
    for plan in (fwd, bwd):
        assert plan.rows == 32
        assert plan.per_sm == min(4, 233472 // (plan.total + 1024))
        assert plan.grid(8 * 8 * 128 * 128, 132) == plan.per_sm * 132
        assert plan.grid(100, 132) == 4 and plan.grid(0, 132) == 1
    if form == "layernet":
        # 12.4 KB of parameters, four blocks an SM both ways
        assert fwd.smem[0][1] + fwd.smem[1][1] == 12672
        assert (fwd.total, bwd.total, fwd.per_sm, bwd.per_sm) == (24960, 41344, 4, 4)
    if form == "wide4":   # the largest admitted form: 66.5 KB of parameters
        assert fwd.smem[0][1] + fwd.smem[1][1] == 66560 and bwd.per_sm == 1


def test_mlp_f32_plan_refuses():
    """What K10 does not compute, at either dtype: five layers, a width
    over 64 or not a multiple of 16, C0 over 64, another activation."""
    for c0, widths, acts in [(32, (32,) * 5, ("relu",) * 5), (32, (80,), ("relu",)),
                             (32, (24,), ("relu",)), (65, (32,), ("relu",)),
                             (32, (32,), ("gelu",))]:
        for bwd in (False, True):
            with pytest.raises(ValueError):
                mf.mlp_f32_plan(c0, widths, acts, bwd)


def _case(form, n, seed):
    c0, widths, acts = FORMS[form]
    g = torch.Generator().manual_seed(seed)
    dims = (c0, *widths)
    x = torch.randn((n, c0), generator=g)
    ws = [torch.randn((ci, co), generator=g) / ci**0.5 for ci, co in zip(dims[:-1], dims[1:])]
    bs = [0.1 * torch.randn(co, generator=g) for co in widths]
    cot = torch.randn((n, widths[-1]), generator=g)
    return x, ws, bs, acts, cot


def _close(got, want, tol=TOL):
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= tol * want.abs().max().item()


@pytest.mark.parametrize("form", list(FORMS))
def test_mlp_f32_walks(form):
    """The f32 bodies' order over 300 ragged rows (10 tiles, the last of 12
    rows, on 3 SMs) against the plain f32 versions."""
    x, ws, bs, acts, cot = _case(form, 300, 1)
    _close(mf._mlp_f32_walk(x, ws, bs, acts), mf._mlp_plain(x, ws, bs, acts))
    for compute_dx in (True, False):
        dx, dws, dbs = mf._mlp_bwd_f32_walk(x, cot, ws, bs, acts, compute_dx)
        pdx, pdws, pdbs = mf._mlp_bwd_rows(x, cot, ws, bs, acts, compute_dx)
        for got, want in zip(dws + dbs, pdws + pdbs):
            _close(got, want)
        if compute_dx:
            _close(dx, pdx)
        else:
            assert dx is None


class _Launch(Exception):
    """A launch intercepted at the kernel lookup; ``args[0]`` the entry point."""


@pytest.fixture
def launches(monkeypatch):
    """The wrappers as on a card, their tensors on the CPU: the kernel
    lookup raises ``_Launch`` with the entry point's name."""
    monkeypatch.setattr(mf, "_require_cuda", lambda name, *ts: torch.device("cpu"))

    def kernel(name, *argtypes):
        raise _Launch(name)

    monkeypatch.setattr(_build, "kernel", kernel)
    monkeypatch.setattr(_build, "sm_count", lambda idx: 132)
    monkeypatch.setattr(_build, "stream_of", lambda dev: 0)


def _entry(fn, *args, **kw):
    with pytest.raises(_Launch) as info:
        fn(*args, **kw)
    return info.value.args[0]


@pytest.mark.parametrize("form", list(FORMS))
def test_mlp_routes_by_dtype(launches, form):
    x, ws, bs, acts, cot = _case(form, 40, 2)
    assert _entry(mf._mlp_fwd_kernel, x, ws, bs, acts) == "wcmc_mlp_fused_f32"
    tiled = form == "layernet"
    for compute_dx in (True, False):   # LayerNet's backward on the tensor cores
        assert _entry(mf._mlp_bwd_kernel, x, cot, ws, bs, acts, compute_dx) == \
            ("wcmc_mlp_fused_bwd_tf32" if tiled else "wcmc_mlp_fused_bwd_f32")
        assert _entry(mf._mlp_bwd_kernel, x, cot, ws, bs, acts, compute_dx,
                      body="simt") == "wcmc_mlp_fused_bwd_f32"
    with pytest.raises(ValueError):   # f32 rows' forward has one body
        mf._mlp_fwd_kernel(x, ws, bs, acts, body="wmma")
    with pytest.raises(ValueError):   # no such f32 body
        mf._mlp_bwd_kernel(x, cot, ws, bs, acts, True, body="tiled")
    xb = x.to(torch.bfloat16)
    assert _entry(mf._mlp_fwd_kernel, xb, ws, bs, acts) == \
        ("wcmc_mlp_fused_tiled" if tiled else "wcmc_mlp_fused")
    assert _entry(mf._mlp_bwd_kernel, xb, cot, ws, bs, acts, True) == \
        ("wcmc_mlp_fused_bwd_tiled" if tiled else "wcmc_mlp_fused_bwd")
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError):
            mf._mlp_fwd_kernel(x.to(dtype), ws, bs, acts)
        with pytest.raises(TypeError):
            mf._mlp_bwd_kernel(x.to(dtype), cot, ws, bs, acts, True)


def test_mlp_f32_wrappers_check_shapes(launches):
    """A weight that does not chain or a cotangent of the wrong shape is a
    ValueError before any launch; no rows is no launch."""
    x, ws, bs, acts, cot = _case("layernet", 40, 3)
    with pytest.raises(ValueError):
        mf._mlp_fwd_kernel(x, [ws[0], ws[1][:16], ws[2]], bs, acts)
    with pytest.raises(ValueError):
        mf._mlp_bwd_kernel(x, cot[:, :16], ws, bs, acts, True)
    assert tuple(mf._mlp_fwd_kernel(x[:0], ws, bs, acts).shape) == (0, 32)
    dx, dws, dbs = mf._mlp_bwd_kernel(x[:0], cot[:0], ws, bs, acts, True)
    assert tuple(dx.shape) == (0, 32) and not any(t.any() for t in dws + dbs)


@pytest.fixture
def pallas():
    """wcmc_tpu's fused MLP on its Pallas kernels, interpreted."""
    old = jpk.INTERPRET, jmf.FORCE_PALLAS
    jpk.INTERPRET, jmf.FORCE_PALLAS = True, True
    try:
        yield
    finally:
        jpk.INTERPRET, jmf.FORCE_PALLAS = old


def _jnp(t):
    return np.asarray(jnp.asarray(t, jnp.float32), np.float64)


def test_pixel_mlp_f32_against_pallas(pallas):
    """PixelMLP at f32 over 300 ragged rows (2 x 3 x 5 x 10): the output,
    d(x) and every parameter's gradient against wcmc_tpu's PixelMLP with
    its forward and backward on the Pallas kernels, interpreted."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 5, 10, 29)).astype(np.float32)
    g = rng.standard_normal((2, 3, 5, 10, 32)).astype(np.float32)
    jm = JPixelMLP((32, 32, 32), LEAKY3, compute_dx=True)
    params = jm.init(jax.random.PRNGKey(6), jnp.asarray(x))["params"]
    tm = convert.load_flax_params(TPixelMLP(29, (32, 32, 32), LEAKY3), params)
    y_j, vjp = jax.vjp(lambda p, x_: jm.apply({"params": p}, x_), params, jnp.asarray(x))
    dp_j, dx_j = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    _build.reset_counts()
    y = tm(xt)
    y.backward(torch.from_numpy(g))
    assert dict(_build.plain_calls) == {"mlp_fused": 1, "mlp_fused_bwd": 1}
    assert y.dtype == torch.float32
    _close(y.detach(), _jnp(y_j))
    _close(xt.grad, _jnp(dx_j))
    got = jax.tree_util.tree_leaves(convert.grads_to_flax(tm))
    for a, b in zip(got, jax.tree_util.tree_leaves(dp_j)):
        _close(np.asarray(a, np.float64), _jnp(b))


def test_layernet_f32_forward_against_pallas(pallas):
    """The port's LBMC LayerNet forward at f32 (K = 5, 1 image x 3 spp x 12
    x 12 px: its embedding 432 rows through K10's f32 route) against
    wcmc_tpu's with the embedding on the Pallas kernel, interpreted."""
    rng = np.random.default_rng(7)
    batch = {"radiance": (2.0 * rng.random((1, 3, 12, 12, 3))).astype(np.float32),
             "features": rng.standard_normal((1, 3, 12, 12, 29)).astype(np.float32)}
    # the port's seeded init carried to wcmc_tpu (a flax init costs seconds here)
    tm = TLayerNet(n_in=29, ksize=5, generator=torch.Generator().manual_seed(8))
    y_j = JLayerNet(n_in=29, ksize=5).apply({"params": convert.to_flax(tm)},
                                            {k: jnp.asarray(v) for k, v in batch.items()})
    _build.reset_counts()
    with torch.no_grad():
        y = tm({k: torch.from_numpy(v) for k, v in batch.items()})
    assert _build.plain_calls["mlp_fused"] == 1 and y.dtype == torch.float32
    _close(y, _jnp(y_j))
