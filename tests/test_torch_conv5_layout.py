"""What surrounds the fused convolution K6 on the card, on the CPU: its
plan, the packed weight layout it streams, the cache that packs a weight
once, the padded pixel pitch of the fused chain's hidden layers, and a
plain walk of the kernel's tile, pass, chunk and tap order.

* ``pack_weights`` / ``unpack_weights``: an exact round trip, each 8 x 8
  block one K-major core matrix, each (pass, tap) one contiguous run.
* A strided NHWC view at a padded pitch, its pad channels zero, gives
  ``conv2d_plain``'s result exactly; ``conv2d_padded`` returns such a view
  of the same values; the fused chain through it is the chain of plain
  per-layer convolutions (exactly) and wcmc_tpu's ``ConvChain(fused=True)``
  (f32 1e-4, bf16 1e-2 of max |ref|, as ``tests/test_torch_conv5.py``).
* The walk: the kernel's order of sums over the packed weights, in f32,
  within 1e-5 (absolute) of ``conv2d_plain`` in f32: only the order of
  the f32 sums differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wcmc_tpu.models.blocks import ConvChain as JConvChain
from wcmc_tpu_torch import convert
from wcmc_tpu_torch.models.blocks import ConvChain as TConvChain
from wcmc_tpu_torch.ops import _build
from wcmc_tpu_torch.ops import conv5
from wcmc_tpu_torch.ops.mlp_fused import _act

WALK_ATOL = 1e-5


def _case(b, h, w, cin, cout, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    wgt = (rng.standard_normal((k, k, cin, cout)) / np.sqrt(k * k * cin)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(wgt), torch.from_numpy(bias)


@pytest.mark.parametrize("k,cin,cout,n", [(5, 39, 100, 104), (5, 100, 441, 224),
                                          (3, 7, 9, 104), (5, 151, 225, 224)])
def test_pack_round_trip(k, cin, cout, n):
    _, w, _ = _case(1, k, k, cin, cout, k, 0)
    npass, cin_pad = -(-cout // n), -(-cin // 16) * 16
    packed = conv5.pack_weights(w, n, cin_pad, torch.float32)
    assert tuple(packed.shape) == (npass, k * k, cin_pad // 16, n // 8, 2, 8, 8)
    assert torch.equal(conv5.unpack_weights(packed, k, cin, cout), w)
    # zero past Cin and Cout
    assert torch.count_nonzero(packed) == torch.count_nonzero(w)
    # bf16: the weights rounded once, as the kernel multiplies them
    bf = conv5.pack_weights(w, n, cin_pad + 16)
    assert bf.dtype == torch.bfloat16
    assert torch.equal(conv5.unpack_weights(bf, k, cin, cout), w.to(torch.bfloat16))


def test_pack_core_matrix_order():
    _, w, _ = _case(1, 5, 5, 48, 300, 5, 1)
    packed = conv5.pack_weights(w, 224, 48, torch.float32)
    # [pass][tap][k16 step][n8 group][k half][8 output channels][8 input channels]
    for p, t, ks, j, kh, r, c in [(1, 7, 2, 3, 1, 5, 2), (0, 24, 0, 27, 0, 7, 7),
                                  (0, 0, 1, 0, 1, 0, 3)]:
        dy, dx = divmod(t, 5)
        assert packed[p, t, ks, j, kh, r, c] == w[dy, dx, 16 * ks + 8 * kh + c,
                                                   224 * p + 8 * j + r]
    # one (pass, tap) slice is one contiguous run of k16 steps of 16 . n values
    flat = packed.reshape(-1)
    assert torch.equal(flat[(1 * 25 + 7) * 3 * 224 * 16:][:3 * 224 * 16],
                       packed[1, 7].reshape(-1))


@pytest.mark.parametrize("cin,cout,k,want", [
    (39, 100, 5, (104, 16, 1, 48, 48)),       # KPCN layer 1 with paths
    (34, 100, 5, (104, 16, 1, 48, 48)),       # layer 1 without paths
    (100, 100, 5, (104, 16, 1, 112, 112)),    # layers 2-8
    (100, 441, 5, (224, 8, 2, 112, 112)),     # layer 9: two passes over one staged tile
    (200, 130, 5, (224, 8, 1, 224, 112)),     # two chunks of 112, the last padded
    (151, 60, 5, (104, 16, 1, 160, 80)),      # two chunks of 80
    (16, 104, 5, (104, 16, 1, 16, 16)),
    (16, 105, 5, (224, 8, 1, 16, 16)),
])
def test_kernel_plan(cin, cout, k, want):
    plan = conv5.kernel_plan(cin, cout, k)
    assert tuple(plan) == want
    assert conv5._smem(k, plan.chunk, plan.n, plan.rows, plan.npass) <= conv5.SMEM_LIMIT
    # whole chunks, none of them all padding
    assert plan.cin_pad % plan.chunk == 0 and plan.cin_pad - plan.chunk < cin


def test_kernel_plan_splits_cin_to_fit():
    plan = conv5.kernel_plan(128, 441, 21)
    assert plan == (224, 8, 2, 144, 48)
    assert conv5._smem(21, plan.chunk, plan.n, plan.rows, plan.npass) <= conv5.SMEM_LIMIT
    # one chunk fewer (of 64) does not fit
    assert conv5._smem(21, 64, plan.n, plan.rows, plan.npass) > conv5.SMEM_LIMIT


def test_weight_cache_packs_once_per_value():
    _, w, _ = _case(1, 5, 5, 8, 20, 5, 2)
    conv5._packed.clear()
    first = conv5._packed_weights(w, 104, 16)
    assert conv5._packed_weights(w, 104, 16) is first
    # the chain passes a permuted view of the parameter on every call
    param = torch.nn.Parameter(w.permute(3, 2, 0, 1).contiguous())
    view = conv5._packed_weights(param.permute(2, 3, 1, 0), 104, 16)
    assert conv5._packed_weights(param.permute(2, 3, 1, 0), 104, 16) is view
    assert torch.equal(view, first.to(view.dtype))
    # an in-place update (an optimizer step) bumps the version: packed anew
    with torch.no_grad():
        param.mul_(2)
    again = conv5._packed_weights(param.permute(2, 3, 1, 0), 104, 16)
    assert again is not view and torch.equal(again.float(), 2 * view.float())
    for _ in range(conv5.PACK_CACHE_SIZE + 3):
        conv5._packed_weights(torch.randn(5, 5, 8, 20), 104, 16)
    assert len(conv5._packed) == conv5.PACK_CACHE_SIZE
    # a tensor made in inference mode has no version counter: packed, not kept
    with torch.inference_mode():
        made = torch.ones(5, 5, 8, 20)
        assert torch.equal(conv5._packed_weights(made, 104, 16).float(),
                           conv5.pack_weights(made, 104, 16, torch.float32))
    assert len(conv5._packed) == conv5.PACK_CACHE_SIZE


def test_pitched_copy_and_view():
    x, _, _ = _case(2, 6, 7, 39, 1, 5, 3)
    assert not conv5._copyable(x.to(torch.bfloat16))
    xp = conv5._pitched(x.to(torch.bfloat16), conv5.padded_pitch(39))
    assert xp.stride() == (6 * 7 * 40, 7 * 40, 40, 1) and conv5._copyable(xp)
    assert torch.equal(xp, x.to(torch.bfloat16))
    assert conv5.padded_pitch(100) == 104 and conv5.padded_pitch(441) == 448
    z = conv5._pitched(x, 48, fill=0)
    assert torch.equal(z._base[..., 39:], torch.zeros(2, 6, 7, 9))
    assert conv5._copyable(conv5._pitched(torch.zeros(1, 3, 3, 100), 104, fill=0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_padded_view_gives_the_plain_result(dtype):
    x, w, bias = _case(2, 14, 17, 100, 100, 5, 4)
    x = x.to(dtype)
    view = conv5._pitched(x, 104, fill=0)
    assert view.stride()[2] == 104 and not view.is_contiguous()
    assert torch.equal(conv5.conv2d_plain(view, w, bias, 5, "relu"),
                       conv5.conv2d_plain(x, w, bias, 5, "relu"))
    _build.reset_counts()
    y = conv5.conv2d_padded(view, w, bias, 5, "relu")
    assert dict(_build.plain_calls) == {"conv5": 1} and not _build.launches
    assert tuple(y.shape) == (2, 10, 13, 100) and y.stride() == (10 * 13 * 104, 13 * 104, 104, 1)
    assert torch.equal(y, conv5.conv2d(x, w, bias, 5, "relu"))
    assert not y._base[..., 100:].any()
    # a direct conv2d call stays contiguous
    assert conv5.conv2d(view, w, bias, 5, "relu").is_contiguous()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padded_chain_against_plain_and_jax(dtype):
    """A chain whose hidden width (20) is padded to a pitch of 24: every
    hidden layer reaches the next as the padded view, the output equals
    the plain per-layer convolutions exactly and wcmc_tpu's fused chain
    within the tolerances of ``tests/test_torch_conv5.py``."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 26, 23, 7)).astype(np.float32)
    jdt = None if dtype == "float32" else jnp.bfloat16
    tdt = None if dtype == "float32" else torch.bfloat16
    jchain = JConvChain(9, width=20, depth=3, ksize=5, pad=False, fused=True, dtype=jdt)
    params = jchain.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    want = np.asarray(jnp.asarray(jchain.apply({"params": params}, jnp.asarray(x)),
                                  jnp.float32), np.float64)
    chain = TConvChain(7, 9, width=20, depth=3, ksize=5, dtype=tdt)
    convert.load_flax_params(chain, params)
    inputs = []
    real = conv5._forward

    def spy(x_, *rest):
        inputs.append(x_)
        return real(x_, *rest)

    conv5._forward = spy
    try:
        with torch.no_grad():
            got = chain(torch.from_numpy(x), fused=True)
    finally:
        conv5._forward = real
    assert [t.stride()[2] for t in inputs] == [7, 24, 24] and got.is_contiguous()
    h = torch.from_numpy(x).to(tdt or torch.float32)
    for i in range(3):
        conv = getattr(chain, f"Conv_{i}")
        h = conv5.conv2d_plain(h, conv.weight.detach().permute(2, 3, 1, 0), conv.bias.detach(),
                               5, "relu" if i < 2 else None)
    assert torch.equal(got, h)
    tol = 1e-4 if dtype == "float32" else 1e-2
    err = np.max(np.abs(got.float().numpy().astype(np.float64) - want))
    assert err <= tol * np.max(np.abs(want)), err


def _walk(x, packed, bias, k, act, plan, cout, pitch):
    """K6's order of work in plain PyTorch: for each block's tile of
    ``plan.rows`` x 16 output pixels, the staged input (zero past the
    image and past Cin), then each pass of ``plan.n`` channels, each chunk
    of input channels and each tap, one product of the staged pixels with
    the tap's packed slice read back as a (chunk, n) matrix; the epilogue
    adds the bias, applies the activation and writes the tile's channels
    below the pitch (zeros from Cout on)."""
    b, h, w, cin = x.shape
    ho, wo, rows, tw, n = h - k + 1, w - k + 1, plan.rows, conv5.TILE_W, plan.n
    staged = torch.zeros((b, -(-ho // rows) * rows + k - 1, -(-wo // tw) * tw + k - 1,
                          plan.cin_pad))
    staged[:, :h, :w, :cin] = x
    bias_p = torch.zeros(plan.npass * n)
    bias_p[:cout] = bias
    y = torch.full((b, ho, wo, pitch), float("nan"))
    for bi in range(b):
        for y0 in range(0, ho, rows):
            for x0 in range(0, wo, tw):
                tile = staged[bi, y0:y0 + rows + k - 1, x0:x0 + tw + k - 1]
                for p in range(plan.npass):
                    acc = torch.zeros((rows, tw, n))
                    for c0 in range(0, plan.cin_pad, plan.chunk):
                        cw = plan.chunk
                        for t in range(k * k):
                            dy, dx = divmod(t, k)
                            # [k16 step][n8 group][k half][n][k] -> (chunk, n)
                            slab = packed[p, t, c0 // 16:(c0 + cw) // 16]
                            bmat = slab.permute(0, 2, 4, 1, 3).reshape(cw, n)
                            acc += tile[dy:dy + rows, dx:dx + tw, c0:c0 + cw] @ bmat
                    z = _act(act or "linear", acc + bias_p[p * n:(p + 1) * n])
                    z[..., max(0, cout - p * n):] = 0.0
                    n1 = min(pitch, (p + 1) * n) - p * n
                    if n1 > 0:
                        oy, ox = min(rows, ho - y0), min(tw, wo - x0)
                        y[bi, y0:y0 + oy, x0:x0 + ox, p * n:p * n + n1] = z[:oy, :ox, :n1]
    return y


@pytest.mark.parametrize("b,h,w,cin,cout,k,act,padded", [
    (1, 21, 37, 39, 100, 5, "relu", True),        # layer 1: Cin 39 in one chunk of 48
    (2, 13, 20, 100, 441, 5, None, False),        # layer 9: two passes over one tile
    (1, 12, 22, 151, 60, 5, "leaky_relu", True),  # two chunks of input channels
    (1, 9, 18, 20, 449, 3, "relu", False),        # three passes, 3x3
    (1, 8, 8, 16, 105, 5, "relu", True),          # Cout one past a 104-channel pass
])
def test_kernel_walk_equals_plain(b, h, w, cin, cout, k, act, padded):
    x, wgt, bias = _case(b, h, w, cin, cout, k, 6)
    plan = conv5.kernel_plan(cin, cout, k)
    if cin > 128:
        assert plan.chunk < plan.cin_pad
    packed = conv5.pack_weights(wgt, plan.n, plan.cin_pad, torch.float32)
    pitch = conv5.padded_pitch(cout) if padded else cout
    got = _walk(x, packed, bias, k, act, plan, cout, pitch)
    want = conv5.conv2d_plain(x, wgt, bias, k, act)
    assert not got.isnan().any()
    assert torch.allclose(got[..., :cout], want, rtol=0, atol=WALK_ATOL)
    assert not got[..., cout:].any()
