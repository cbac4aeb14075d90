"""The decision of ``chip_smoke.py``'s train-step cross-check
(``xcheck_decision``), on synthetic gradient vectors and losses: one bf16
step on the card (g_c) against the CPU's bf16 (g_b) and f32 (g_f) steps
from the same state passes when it is as far from g_b as the CPU's own
bf16 step is from f32, and fails a dropped bias gradient, a gradient
scaled by 1.05, and, where the state's bf16 noise is near zero, anything
beyond the floor beta (beta_loss for a loss)."""

import importlib.util
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

N = 20000
# |g_b - g_f| / |g_f|: the CPU bf16 step's distance from f32 at a state of
# little bf16 noise (KPCN's backbone_diffuse read 0.0057 after its train phase)
NOISE = 0.005


def _vec(rng, n=N):
    return torch.from_numpy(rng.standard_normal(n))


def _noise(rng, like, size):
    """A random vector of norm ``size``."""
    v = _vec(rng, like.numel())
    return v * (size / v.norm())


def _state(seed, noise=NOISE):
    rng = np.random.default_rng(seed)
    f = _vec(rng)
    # the last 64 entries: a bias gradient, larger per element than the weights'
    f[-64:] *= 8.0
    b = f + _noise(rng, f, noise * f.norm())
    return rng, f, b


def _decide(card, bf16, f32, losses=None):
    c_loss, b_loss, f_loss = losses or ({}, {}, {})
    return cs.xcheck_decision({"m": card}, {"m": bf16}, {"m": f32}, c_loss, b_loss, f_loss)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_passes_a_step_as_far_from_bf16_as_bf16_is_from_f32(seed):
    rng, f, b = _state(seed)
    n = (b - f).norm()
    card = b + _noise(rng, b, n)   # |g_c - g_b| = n, |g_c - g_f| about sqrt(2) n
    terms, bad = _decide(card, b, f)
    assert bad == [], terms
    t = terms["m"]
    assert t["n"] == pytest.approx(float(n)) and t["card-bf16"] == pytest.approx(float(n))
    assert t["limit_bf16"] == pytest.approx(cs.XCHECK["alpha"] * float(n)
                                            + cs.XCHECK["beta"] * float(f.norm()))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fails_a_dropped_bias_gradient(seed):
    rng, f, b = _state(seed)
    card = b + _noise(rng, b, (b - f).norm())
    card[-64:] = 0.0
    terms, bad = _decide(card, b, f)
    assert bad == ["m"], terms


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fails_a_gradient_scaled_by_1_05(seed):
    _, f, b = _state(seed)
    terms, bad = _decide(1.05 * b, b, f)
    assert bad == ["m"], terms
    _, bad = _decide(1.05 * f, b, f)
    assert bad == ["m"]


@pytest.mark.parametrize("within,passes", [(0.5, True), (2.0, False)])
def test_near_zero_noise_passes_only_within_beta(within, passes):
    rng = np.random.default_rng(3)
    f = _vec(rng)
    b = f.clone()   # n = 0: the bf16 step equals the f32 step
    card = f + _noise(rng, f, within * cs.XCHECK["beta"] * f.norm())
    terms, bad = _decide(card, b, f)
    assert terms["m"]["n"] == 0.0
    assert (bad == []) == passes, terms


def test_losses_are_held_the_same_way():
    _, f, b = _state(4)
    lf, lb = 0.25, 0.25 * (1 + 2e-3)
    n = abs(lb - lf)
    beta = cs.XCHECK["beta_loss"]
    ok = lb + n                                      # as far from L_b as L_b from L_f
    off = lf * (1 + 2 * beta) + cs.XCHECK["alpha_f32"] * n   # past the f32 limit
    terms, bad = _decide(b, b, f, ({"l": ok, "k": lf}, {"l": lb, "k": lf}, {"l": lf, "k": lf}))
    assert bad == [], terms
    assert terms["k"]["n"] == 0.0 and terms["k"]["limit_f32"] == pytest.approx(beta * lf)
    _, bad = _decide(b, b, f, ({"l": off}, {"l": lb}, {"l": lf}))
    assert bad == ["l"]
