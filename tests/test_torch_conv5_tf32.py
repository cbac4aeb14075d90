"""What surrounds K6's tensor-core f32 body (``csrc/conv5_tf32.cu``, split
TF32 on ``wgmma``), on the CPU (the kernel runs only on the card:
``tests/test_torch_kernels_gpu.py``).

* ``tf32_round`` / ``split_tf32`` (``ops/_tf32.py``): PTX's cvt.rna.tf32.f32
  on the bits (nearest, ties away from zero, 13 low bits zero), and hi + lo
  within 2^-22 of the value.
* ``conv_tc_plan``: the tiling at the fused KPCN's four layer shapes (12-row
  blocks, a pass of 104 channels or passes of 112; Cin in one chunk of
  whole slabs of 8), the shared-memory carve in the
  kernel's order against a block's limit; Cin split into chunks
  where one does not fit; its refusals.
* ``pack_weights_tf32``: element by element the hi and lo of the weight in
  the kernel's (pass, chunk, slab, tap, hi / lo, n8, k half, n, k) order,
  k running over channels 0, 2, 4, 6, 1, 3, 5, 7 of a slab; zero past Cin
  and Cout.
* ``_conv_tc_walk``, the body's split-TF32 arithmetic step by step, against
  ``conv2d_plain`` at f32 and wcmc_tpu's ``conv2d`` at f32 with its Pallas
  kernel interpreted and its XLA form: within 1e-5 of max |ref| (the
  products' dropped lo . lo terms and another order of f32 sums), at odd
  shapes (Cin 34 and 39, Cout 441 in four passes, 3x3).
* The routing of ``_conv_kernel`` on card tensors: f32 to
  ``wcmc_conv5_tf32`` with the plan's tiling, ``body="simt"`` to the SIMT
  body's ``wcmc_conv5_f32``, an unknown body a ValueError; the tf32 pack
  made once per parameter value.  The launch is intercepted at the kernel
  lookup; nothing runs.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wcmc_tpu_torch.ops import _build
from wcmc_tpu_torch.ops import conv5
from wcmc_tpu_torch.ops._tf32 import split_tf32, tf32_round

jc5 = importlib.import_module("wcmc_tpu.ops.conv5")
jmf = importlib.import_module("wcmc_tpu.ops.mlp_fused")
jpk = importlib.import_module("wcmc_tpu.ops.pallas_kernels")

TOL = 1e-5
# (input (B, H, W, Cin), Cout) of the fused KPCN's K6 layers: 1, 5 and 9 of
# the chain with paths on 128-px tiles, layer 1 without paths on 256-px tiles
LAYERS = {"layer1": ((8, 128, 128, 39), 100), "layer5": ((8, 112, 112, 100), 100),
          "layer9": ((8, 96, 96, 100), 441), "nopath1": ((8, 256, 256, 34), 100)}


def test_tf32_round_on_the_bits():
    ulp = 2.0 ** -10
    vals = torch.tensor([1.0 + ulp / 2, 1.0 + ulp / 2 - 2 ** -20, -(1.0 + ulp / 2), 3.0,
                         1.0 + 3 * ulp / 4, 0.0])
    want = torch.tensor([1.0 + ulp, 1.0, -(1.0 + ulp), 3.0, 1.0 + ulp, 0.0])
    assert torch.equal(tf32_round(vals), want)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi, lo = split_tf32(x)
    for t in (hi, lo):
        assert not (t.view(torch.int32) & 0x1FFF).any()
    assert ((hi + lo - x).abs() <= 2.0 ** -22 * x.abs()).all()
    assert ((x - hi).abs() <= 2.0 ** -11 * x.abs()).all()


@pytest.mark.parametrize("layer", list(LAYERS))
def test_conv_tc_plan(layer):
    """One chunk of the whole padded Cin (40 or 104) at a pitch of 8 mod 16
    floats; the carve in the kernel's order, each buffer a multiple of 128
    bytes, within a block's shared memory."""
    (_, _, _, cin), cout = LAYERS[layer]
    plan = conv5.conv_tc_plan(cin, cout, 5)
    n, rows = (104 if cout <= 104 else 112), 12
    assert (plan.n, plan.rows, plan.npass) == (n, rows, -(-cout // n))
    assert plan.chunk == plan.cin_pad == -(-cin // 8) * 8
    assert plan.xpitch % 16 == 8 and plan.xpitch >= plan.chunk
    assert [k for k, _ in plan.smem] == ["x", "w", "bias", "full", "released", "slabs"]
    pix = (rows + 4) * 20
    assert dict(plan.smem)["x"] == -(-4 * pix * plan.xpitch // 128) * 128
    assert dict(plan.smem)["w"] == 4 * 64 * n
    assert all(m % 128 == 0 for _, m in plan.smem)
    assert plan.total == sum(m for _, m in plan.smem) <= conv5.SMEM_LIMIT


def test_conv_tc_plan_chunks_and_refusals():
    """Cin past one chunk's room in equal chunks of whole slabs; a window
    whose input tile cannot fit even one slab, and an empty layer, refuse."""
    plan = conv5.conv_tc_plan(300, 60, 5)       # 304 channels: past the widest chunk, 256
    assert (plan.cin_pad, plan.chunk) == (304, 152) and plan.total <= conv5.SMEM_LIMIT
    plan = conv5.conv_tc_plan(200, 60, 7)       # 7x7: 200 channels' tile passes the limit
    assert conv5.SMEM_LIMIT < sum(m for _, m in conv5._tc_smem(7, 200, 104, 12, 1))
    assert (plan.cin_pad, plan.chunk) == (208, 104) and plan.total <= conv5.SMEM_LIMIT
    assert conv5.conv_tc_plan(40, 229, 7).npass == 3
    with pytest.raises(ValueError):
        conv5.conv_tc_plan(8, 8, 80)
    with pytest.raises(ValueError):
        conv5.conv_tc_plan(0, 100, 5)


def test_pack_weights_tf32():
    g = torch.Generator().manual_seed(0)
    w = torch.randn((5, 5, 39, 150), generator=g)
    plan = conv5.conv_tc_plan(39, 150, 5)
    wp = conv5.pack_weights_tf32(w, plan.n, plan.chunk, plan.cin_pad)
    assert (plan.n, plan.npass, plan.chunk) == (112, 2, 40)
    assert tuple(wp.shape) == (2, 1, 5, 25, 2, 14, 2, 8, 4) and wp.is_contiguous()
    hi, lo = split_tf32(w)
    order = conv5._k_order()
    rng = np.random.default_rng(1)
    for _ in range(300):
        p, sl, tap, hl, j, kh, r, k4 = (int(rng.integers(0, m))
                                        for m in (2, 5, 25, 2, 14, 2, 8, 4))
        ch, n = 8 * sl + order[4 * kh + k4], 112 * p + 8 * j + r
        dy, dx = divmod(tap, 5)
        want = 0.0 if ch >= 39 or n >= 150 else (hi, lo)[hl][dy, dx, ch, n].item()
        assert wp[p, 0, sl, tap, hl, j, kh, r, k4].item() == want
    assert not wp[1, :, :, :, :, 38 // 8 + 1:].any()     # channels 150 - 223
    # each step one contiguous block of 64 n bytes
    assert wp[0, 0, 0, 0].numel() * 4 == 64 * plan.n


CASES = [(1, 12, 20, 7, 9, 5, "relu"),             # one block, one slab
         (2, 14, 25, 20, 70, 5, "leaky_relu"),     # 3 slabs, 2 x 2 tiles
         (1, 9, 11, 3, 5, 3, None),                # 3x3
         (1, 10, 12, 39, 441, 5, None),            # layer 1's Cin, layer 9's four passes
         (1, 9, 9, 34, 100, 5, "relu")]            # layer 1 without paths


def _case(b, h, w, cin, cout, k, seed=1):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, h, w, cin)).astype(np.float32))
    wgt = torch.from_numpy((rng.standard_normal((k, k, cin, cout))
                            / (k * k * cin) ** 0.5).astype(np.float32))
    return x, wgt, torch.from_numpy((0.1 * rng.standard_normal(cout)).astype(np.float32))


def _close(got, want, tol=TOL):
    got = torch.as_tensor(np.asarray(got, np.float64))
    want = torch.as_tensor(np.asarray(want, np.float64))
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= tol * want.abs().max().item()


@pytest.mark.parametrize("b,h,w,cin,cout,k,act", CASES)
def test_conv_tc_walk(b, h, w, cin, cout, k, act):
    x, wgt, bias = _case(b, h, w, cin, cout, k)
    got = conv5._conv_tc_walk(x, wgt, bias, k, act)
    _close(got, conv5.conv2d_plain(x, wgt, bias, k, act))
    args = (jnp.asarray(x.numpy()), jnp.asarray(wgt.numpy()), jnp.asarray(bias.numpy()))
    _close(got, jc5._conv_xla(*args, k, act))
    if cout <= 128:   # the Pallas kernel interpreted (slow for wide layers on the CPU)
        jpk.INTERPRET, jmf.FORCE_PALLAS = True, True
        try:
            want = jc5.conv2d(*args, k, act)
        finally:
            jpk.INTERPRET, jmf.FORCE_PALLAS = False, False
        _close(got, jnp.asarray(want, jnp.float32))


class _Launch(Exception):
    """A launch intercepted at the kernel lookup; ``args`` the entry point
    and the launch's arguments."""


@pytest.fixture
def launches(monkeypatch):
    monkeypatch.setattr(conv5, "_require_cuda", lambda x, w, b: torch.device("cpu"))

    def kernel(name, *argtypes):
        def launch(*args):
            raise _Launch(name, args)
        return launch

    monkeypatch.setattr(_build, "kernel", kernel)
    monkeypatch.setattr(_build, "stream_of", lambda dev: 0)


def _launch(fn, *args, **kw):
    with pytest.raises(_Launch) as info:
        fn(*args, **kw)
    return info.value.args


@pytest.mark.parametrize("layer", ["layer1", "layer9"])
def test_conv_routes_f32_to_the_tensor_cores(launches, layer):
    (_, _, _, cin), cout = LAYERS[layer]
    x, wgt, bias = _case(1, 12, 20, cin, cout, 5)
    plan = conv5.conv_tc_plan(cin, cout, 5)
    name, args = _launch(conv5._conv_kernel, x, wgt, bias, 5, "relu", True)
    assert name == "wcmc_conv5_tf32"
    assert args[14:18] == (plan.n, plan.cin_pad, plan.chunk, 1)
    # Cin copied once to a pitch of 8 channels (39 -> 40, 100 -> 104)
    assert args[10] == conv5.padded_pitch(cin) and args[12] == conv5.padded_pitch(cout)
    name, _ = _launch(conv5._conv_kernel, x, wgt, bias, 5, "relu", body="simt")
    assert name == "wcmc_conv5_f32"
    with pytest.raises(ValueError, match="body"):
        conv5._conv_kernel(x, wgt, bias, 5, "relu", body="wmma")


def test_conv_tc_packs_once(launches):
    x, wgt, bias = _case(1, 12, 20, 16, 32, 5)
    conv5._packed.clear()
    for _ in range(2):
        _launch(conv5._conv_kernel, x, wgt, bias, 5, None)
    assert (conv5._packed.misses, conv5._packed.hits) == (1, 1)
    wgt.add_(1.0)
    _launch(conv5._conv_kernel, x, wgt, bias, 5, None)
    assert conv5._packed.misses == 2
