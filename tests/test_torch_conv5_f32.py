"""What surrounds the f32 body of K6 (``csrc/conv5_f32.cu``), on the CPU (the
kernel runs only on the card: ``tests/test_torch_kernels_gpu.py``).

* ``conv_f32_plan``: the tiling (8 x 16 output pixels x 64 output channels
  a block, Cin in chunks of 8), the shared-memory carve in the kernel's
  order, the blocks resident an SM and the grid at the fused KPCN's four
  layer shapes, and its refusals.
* ``pack_weights_f32``: the order the kernel stages the weights in, zero
  past Cin and Cout.
* ``_conv_f32_walk``, the f32 body's order (each output a fused
  multiply-add chain from zero in (input chunk, tap, channel) order over
  the packed weights, then the bias and the activation), against
  ``conv2d_plain`` at f32 and wcmc_tpu's ``conv2d`` at f32 with its Pallas
  kernel interpreted: within 1e-5 of max |ref| (the same f32 math summed
  in another order).
* The routing of ``conv2d`` / ``conv2d_padded`` on card tensors by dtype:
  f32 to the tensor-core f32 entry point (the SIMT one with ``body="simt"``;
  the input as it is where ``_copyable``, else one pitched copy), bf16 to
  the ``wgmma`` body, and a TypeError for any other dtype.  The launch is intercepted at the kernel lookup
  (``_build.kernel``), which names the C entry point; nothing runs.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wcmc_tpu_torch.ops import _build
from wcmc_tpu_torch.ops import conv5

jc5 = importlib.import_module("wcmc_tpu.ops.conv5")
jmf = importlib.import_module("wcmc_tpu.ops.mlp_fused")
jpk = importlib.import_module("wcmc_tpu.ops.pallas_kernels")

TOL = 1e-5
# (input (B, H, W, Cin), Cout) of the fused KPCN's K6 layers: 1, 5 and 9 of
# the chain with paths on 128-px tiles, layer 1 without paths on 256-px tiles
LAYERS = {"layer1": ((8, 128, 128, 39), 100), "layer5": ((8, 112, 112, 100), 100),
          "layer9": ((8, 96, 96, 100), 441), "nopath1": ((8, 256, 256, 34), 100)}


@pytest.mark.parametrize("layer", list(LAYERS))
def test_conv_f32_plan(layer):
    """The input tile with its halo at a pitch of 9 floats, then every tap's
    weights of one chunk of 8 input channels x 64 output channels; three
    blocks an SM; a grid of (row and column tiles, channel chunks, images)."""
    (b, h, w, cin), cout = LAYERS[layer]
    plan = conv5.conv_f32_plan(cin, cout, 5)
    assert (plan.rows, plan.cols, plan.chunk, plan.nc) == (8, 16, 8, 64)
    assert [n for n, _ in plan.smem] == ["x", "w"]
    assert [m for _, m in plan.smem] == [8704, 51200]   # 12 x 20 x 9 and 25 x 8 x 64 floats
    assert plan.total == 59904 and plan.per_sm == 3
    assert plan.cin_pad == -(-cin // 8) * 8 and plan.n_out == -(-cout // 64)
    ho, wo = h - 4, w - 4
    assert plan.grid(b, ho, wo) == (-(-ho // 8) * -(-wo // 16), plan.n_out, b)
    assert {"layer1": (128, 2, 8), "layer5": (98, 2, 8), "layer9": (72, 7, 8),
            "nopath1": (512, 2, 8)}[layer] == plan.grid(b, ho, wo)


def test_conv_f32_plan_refuses():
    """A window whose weights of one chunk pass a block's shared memory
    (K = 11), and a layer with no channels."""
    assert conv5.conv_f32_plan(100, 100, 10).total <= conv5.SMEM_LIMIT
    with pytest.raises(ValueError):
        conv5.conv_f32_plan(100, 100, 11)
    with pytest.raises(ValueError):
        conv5.conv_f32_plan(0, 100, 5)


def test_pack_weights_f32():
    g = torch.Generator().manual_seed(0)
    w = torch.randn((5, 5, 39, 100), generator=g)
    wp = conv5.pack_weights_f32(w, 40)
    assert tuple(wp.shape) == (2, 5, 25, 8, 64) and wp.dtype == torch.float32
    assert wp.is_contiguous()
    for j, ch, tap, c, n in [(0, 0, 0, 0, 0), (1, 4, 24, 6, 35), (0, 2, 13, 5, 63)]:
        dy, dx = divmod(tap, 5)
        assert wp[j, ch, tap, c, n] == w[dy, dx, 8 * ch + c, 64 * j + n]
    assert not wp[:, 4, :, 7].any() and not wp[1, :, :, :, 36:].any()


CASES = [(1, 12, 20, 7, 9, 5, "relu"),            # one block, one chunk
         (2, 14, 25, 20, 70, 5, "leaky_relu"),    # 3 input chunks, 2 channel chunks, 2 x 2 tiles
         (1, 9, 11, 3, 5, 3, None)]               # 3x3


def _case(b, h, w, cin, cout, k, seed=1):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, h, w, cin), generator=g)
    wgt = torch.randn((k, k, cin, cout), generator=g) / (k * k * cin) ** 0.5
    return x, wgt, 0.1 * torch.randn(cout, generator=g)


def _close(got, want, tol=TOL):
    got = torch.as_tensor(np.asarray(got, np.float64))
    want = torch.as_tensor(np.asarray(want, np.float64))
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= tol * want.abs().max().item()


@pytest.mark.parametrize("b,h,w,cin,cout,k,act", CASES)
def test_conv_f32_walk(b, h, w, cin, cout, k, act):
    x, wgt, bias = _case(b, h, w, cin, cout, k)
    got = conv5._conv_f32_walk(x, wgt, bias, k, act)
    _close(got, conv5.conv2d_plain(x, wgt, bias, k, act))
    jpk.INTERPRET, jmf.FORCE_PALLAS = True, True
    try:
        want = jc5.conv2d(jnp.asarray(x.numpy()), jnp.asarray(wgt.numpy()),
                          jnp.asarray(bias.numpy()), k, act)
    finally:
        jpk.INTERPRET, jmf.FORCE_PALLAS = False, False
    _close(got, jnp.asarray(want, jnp.float32))


class _Launch(Exception):
    """A launch intercepted at the kernel lookup; ``args`` the entry point
    and the launch's arguments."""


@pytest.fixture
def launches(monkeypatch):
    """``_conv_kernel`` as on a card, its tensors on the CPU: the kernel
    lookup returns a function that raises ``_Launch`` with the entry
    point's name and the launch's arguments."""
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


@pytest.mark.parametrize("padded", [False, True])
def test_conv_routes_by_dtype(launches, padded):
    """f32 to the tensor-core body's ``wcmc_conv5_tf32`` with the plan's
    padded Cin and the output's pitch (104 for 100 channels where padded),
    and to the SIMT body's ``wcmc_conv5_f32`` only with ``body="simt"``;
    Cin 39 copied once to a pitch of 40, a hidden layer's 104-pitched view
    taken as it is; bf16 to ``wcmc_conv5``; float16 and float64 a
    TypeError."""
    x, wgt, bias = _case(1, 12, 20, 39, 100, 5)
    name, args = _launch(conv5._conv_kernel, x, wgt, bias, 5, "relu", padded)
    assert name == "wcmc_conv5_tf32"
    sb, sh, sw, cout, pitch, k, n, cin_pad, chunk, act = args[8:18]
    assert (sw, cout, pitch, k, n, cin_pad, chunk, act) == (40, 100, 104 if padded else 100, 5,
                                                            104, 40, 40, 1)
    name, args = _launch(conv5._conv_kernel, x, wgt, bias, 5, "relu", padded, body="simt")
    assert name == "wcmc_conv5_f32"
    sb, sh, sw, cout, pitch, k, cin_pad, act = args[8:16]
    assert (sw, cout, pitch, k, cin_pad, act) == (40, 100, 104 if padded else 100, 5, 40, 1)
    hidden = conv5._pitched(torch.randn((1, 12, 20, 100)), 104, fill=0)
    _, args = _launch(conv5._conv_kernel, hidden, *_case(1, 12, 20, 100, 100, 5)[1:], 5,
                      "relu", padded)
    assert args[0] == hidden.data_ptr() and args[10] == 104 and args[15] == 104
    name, _ = _launch(conv5._conv_kernel, x.to(torch.bfloat16), wgt, bias, 5, "relu", padded)
    assert name == "wcmc_conv5"
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="bfloat16 or float32"):
            conv5._conv_kernel(x.to(dtype), wgt, bias, 5, "relu", padded)


def test_conv_f32_packs_once(launches):
    """The f32 weights are packed once per parameter value: a second launch
    finds the pack, an in-place update of the weight packs again."""
    x, wgt, bias = _case(1, 12, 20, 16, 32, 5)
    conv5._packed.clear()
    for _ in range(2):
        _launch(conv5._conv_kernel, x, wgt, bias, 5, None)
    assert (conv5._packed.misses, conv5._packed.hits) == (1, 1)
    wgt.add_(1.0)
    _launch(conv5._conv_kernel, x, wgt, bias, 5, None)
    assert conv5._packed.misses == 2
