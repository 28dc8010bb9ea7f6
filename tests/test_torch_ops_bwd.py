"""The plain version of the port's backward kernel,
`ms_deform_attn_1d_bwd_ref`, against (i) torch autograd of the port's plain
forward, (ii) `jax.grad` of the JAX package's plain forward and (iii) the
Pallas custom VJP (the TPU backward kernel) run in interpret mode.

Inputs and the output gradient come from numpy with a seed, with taps in
[0, 1], "wild" taps in [-0.4, 1.4] and taps on the level borders. Tolerance:
rtol 1e-4 and atol 1e-5 x max(1, max |want|) in f32: grad_loc carries the
factor T_l, so its values are up to a few hundred. The port gives grad_loc = 0
on the clamp's two bounds (x = 0, x = T_l - 1 exactly), where `jnp.clip`
passes half the gradient; those taps, a set of measure zero that the border
inputs hit on purpose, are left out of the JAX comparison of grad_loc only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvl_tpu.ops import ms_deform_attn as jax_msda
from gvl_tpu_torch.ops import ms_deform_attn as port
from tests.test_torch_ops import KINDS, inputs, t


def close(got, want, keep=None):
    got, want = np.asarray(got), np.asarray(want)
    atol = 1e-5 * max(1.0, float(np.abs(want).max()))
    if keep is not None:
        got, want = got[keep], want[keep]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol)


def off_bounds(shapes, loc):
    """Taps that do not lie exactly on a clamp bound, in f32 as the ops
    compute the position."""
    T = np.asarray(shapes, np.float32)[None, None, None, :, None]
    x = loc.astype(np.float32) * T - np.float32(0.5)
    return (x != 0) & (x != T - 1)


def world(kind, rng, **kw):
    value, shapes, loc, attn = inputs(kind, rng, **kw)
    B, _, H, Dh = value.shape
    grad_out = rng.randn(B, loc.shape[1], H * Dh).astype(np.float32)
    got = port.ms_deform_attn_1d_bwd_ref(t(grad_out), t(value), shapes, t(loc),
                                         t(attn))
    return value, shapes, loc, attn, grad_out, [g.numpy() for g in got]


@pytest.mark.parametrize("kind", KINDS)
def test_bwd_ref_matches_torch_autograd(rng, kind):
    value, shapes, loc, attn, grad_out, got = world(kind, rng)
    leaves = [t(x).requires_grad_() for x in (value, loc, attn)]
    out = port.ms_deform_attn_1d_ref(leaves[0], shapes, leaves[1], leaves[2])
    want = torch.autograd.grad(out, leaves, t(grad_out))
    for g, w in zip(got, want):
        close(g, w.numpy())


@pytest.mark.parametrize("kind", KINDS)
def test_bwd_ref_matches_jax_grad(rng, kind):
    value, shapes, loc, attn, grad_out, got = world(kind, rng)

    def loss(v, l, a):
        return jnp.sum(jax_msda.ms_deform_attn_1d_ref(v, shapes, l, a)
                       * jnp.asarray(grad_out))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(value), jnp.asarray(loc), jnp.asarray(attn))
    keep = off_bounds(shapes, loc)
    if kind == "border":
        assert not keep.all()             # the border inputs do hit the bounds
    close(got[0], want[0])
    close(got[1], want[1], keep)
    close(got[2], want[2])


@pytest.mark.parametrize("kind", KINDS)
def test_bwd_ref_matches_pallas_vjp_interpret(rng, kind):
    """The TPU backward kernel (interpret mode, as
    tests/test_ms_deform_attn.py runs it), at small shapes."""
    value, shapes, loc, attn, grad_out, got = world(
        kind, rng, B=1, H=2, Dh=8, Lq=10, shapes=(13, 7), P=2)

    def loss(v, l, a):
        out = jax_msda.ms_deform_attn_1d(v, shapes, l, a, impl="pallas")
        return jnp.sum(out * jnp.asarray(grad_out))

    from jax.experimental.pallas import tpu as pltpu
    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=(0, 1, 2))(
            jnp.asarray(value), jnp.asarray(loc), jnp.asarray(attn))
    close(got[0], want[0])
    close(got[1], want[1], off_bounds(shapes, loc))
    close(got[2], want[2])


def test_border_taps_get_zero_loc_gradient_under_autograd(rng):
    """On the clamp's bounds and outside them, autograd of the plain forward
    gives loc no gradient, as the kernel does."""
    value, shapes, loc, attn = inputs("border", rng)
    leaf = t(loc).requires_grad_()
    port.ms_deform_attn_1d_ref(t(value), shapes, leaf, t(attn)).sum().backward()
    T = torch.tensor(shapes, dtype=torch.float32)[:, None]
    x = t(loc) * T - 0.5
    clamped = (x <= 0) | (x >= T - 1)
    assert clamped.any() and not clamped.all()
    assert (leaf.grad[clamped] == 0).all()
    assert (leaf.grad[~clamped] != 0).any()


def test_bwd_wrapper_refuses_cpu_tensors(rng):
    value, shapes, loc, attn, grad_out, _ = world("normal", rng)
    with pytest.raises(ValueError, match="kernel: value is on cpu"):
        port.ms_deform_attn_1d_bwd_cuda(t(grad_out), t(value), shapes, t(loc),
                                        t(attn))
