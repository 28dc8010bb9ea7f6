"""The port's deformable-attention ops (gvl_tpu_torch.ops) against the JAX
package's: prep_taps, the plain dense op, the wrapper on a CPU tensor, the
sampled-values gather, and the Pallas kernel run in interpret mode.

Inputs come from numpy with a seed. Tolerance: 1e-5 absolute / relative in
f32 (both sides sum at most K=16 lerped taps of unit-scale values). Tap
indices must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvl_tpu.ops import ms_deform_attn as jax_msda
from gvl_tpu_torch.ops import ms_deform_attn as port
from tests.test_ms_deform_attn import make_inputs

TOL = dict(rtol=1e-5, atol=1e-5)


def border_inputs(rng, B=2, H=4, Dh=16, Lq=18, shapes=(31, 16, 8, 4), P=4):
    """Taps placed exactly at the clamp edges and level borders: x = 0,
    x = T_l - 1, one row inside each edge, and loc outside [0, 1]."""
    value, shapes, _, attn = make_inputs(rng, B, H, Dh, Lq, shapes, P)
    L = len(shapes)
    loc = np.empty((B, Lq, H, L, P), np.float32)
    for l, T in enumerate(shapes):
        special = np.array([0.5 / T, (T - 0.5) / T, 1.5 / T, (T - 1.5) / T,
                            0.0, 1.0, -0.3, 1.3], np.float32)
        loc[..., l, :] = special[rng.randint(0, len(special),
                                             (B, Lq, H, P))]
    return value, shapes, loc, attn


def inputs(kind, rng, **kw):
    if kind == "border":
        return border_inputs(rng, **kw)
    return make_inputs(rng, wild=(kind == "wild"), **kw)


KINDS = ["normal", "wild", "border"]


def t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("kind", KINDS)
def test_prep_taps_matches_jax(rng, kind):
    _, shapes, loc, attn = inputs(kind, rng)
    want = jax_msda._prep_taps(shapes, jnp.asarray(loc), jnp.asarray(attn))
    got = port.prep_taps(shapes, t(loc), t(attn))
    for w, g in zip(want[:2], got[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for w, g in zip(want[2:], got[2:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_plain_matches_jax_ref(rng, kind):
    value, shapes, loc, attn = inputs(kind, rng)
    want = jax_msda.ms_deform_attn_1d_ref(
        jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(attn))
    got = port.ms_deform_attn_1d_ref(t(value), shapes, t(loc), t(attn))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_plain_matches_pallas_interpret(rng, kind):
    """The TPU kernel itself (interpret mode, as tests/test_ms_deform_attn.py
    runs it) against the port's plain version, at small shapes."""
    value, shapes, loc, attn = inputs(kind, rng, B=1, H=2, Dh=8, Lq=10,
                                      shapes=(13, 7), P=2)
    from jax.experimental.pallas import tpu as pltpu
    with pltpu.force_tpu_interpret_mode():
        want = jax_msda.ms_deform_attn_1d(
            jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(attn),
            impl="pallas")
    got = port.ms_deform_attn_1d_ref(t(value), shapes, t(loc), t(attn))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_wrapper_on_cpu_runs_plain_and_launches_nothing(rng):
    value, shapes, loc, attn = make_inputs(rng, wild=True)
    before = port.ms_deform_attn_1d.launches
    got = port.ms_deform_attn_1d(t(value).double(), shapes, t(loc), t(attn))
    assert port.ms_deform_attn_1d.launches == before
    assert got.dtype == torch.float64          # cast back to value's dtype
    want = port.ms_deform_attn_1d_ref(t(value), shapes, t(loc), t(attn))
    np.testing.assert_array_equal(got.float().numpy(), want.numpy())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("jax_impl", ["twohot", "gather"])
def test_sampled_values_match_jax(rng, kind, jax_impl):
    value, shapes, loc, attn = inputs(kind, rng)
    want = jax_msda.ms_deform_attn_1d_sampled_values(
        jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(attn),
        impl=jax_impl)
    got = port.ms_deform_attn_1d_sampled_values(t(value), shapes, t(loc))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_kernel_wrapper_refuses_cpu_tensors(rng):
    value, shapes, loc, attn = make_inputs(rng)
    with pytest.raises(ValueError, match="kernel: value is on cpu"):
        port.ms_deform_attn_1d_cuda(t(value), shapes, t(loc), t(attn))
