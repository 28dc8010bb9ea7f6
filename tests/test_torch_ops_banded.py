"""The port's banded deformable attention (gvl_tpu_torch.ops.
ms_deform_attn_banded) against the JAX package's banded op, whose Pallas
kernels run in interpret mode as tests/test_msda_banded.py runs them.

Inputs come from numpy with a seed, one query per token, in three classes:
  local   encoder-like reference points, offsets within +-3 rows, margin 8:
          the band covers every tap, the result is the dense op's;
  full    arbitrary taps in [0, 1] with a margin that makes every band the
          whole (padded) level: exact whatever the taps;
  clamp   offsets of up to +-60 rows at margin 4: taps leave the band and are
          clamped to its edge; the result differs from the dense op's.
The levels (300, 150, 75, 38) give tiles of 128 + 128 + 44, 128 + 22, 75 and
38 queries and two levels whose length is not a multiple of 8.

Tolerances, f32: forward atol 2e-6 / rtol 2e-5, gradients rtol 5e-4 / atol
1e-5 x max(1, max |want|) (grad_loc carries the factor T_l): those of
tests/test_msda_banded.py. The port gives grad_loc = 0 on the tap clamp's
bounds where `jnp.clip` passes half; such taps are left out of the JAX
comparison of grad_loc, as in tests/test_torch_ops_bwd.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gvl_tpu.ops import ms_deform_attn_banded as jax_banded
from gvl_tpu_torch.ops import ms_deform_attn as dense
from gvl_tpu_torch.ops import ms_deform_attn_banded as port
from tests.test_torch_ops_bwd import off_bounds

SHAPES = (300, 150, 75, 38)
S = sum(SHAPES)
B, H, DH, P = 1, 2, 8, 2
L = len(SHAPES)
KINDS = {"local": (3.0, 8), "full": (None, 512), "clamp": (60.0, 4)}
FWD_TOL = dict(rtol=2e-5, atol=2e-6)


def t(x):
    return torch.from_numpy(np.asarray(x))


def world(kind, rng):
    spread, margin = KINDS[kind]
    value = rng.randn(B, S, H, DH).astype(np.float32)
    if spread is None:
        loc = rng.rand(B, S, H, L, P).astype(np.float32)
    else:
        ref = np.concatenate([(np.arange(T) + 0.5) / T for T in SHAPES])
        offsets = rng.uniform(-spread, spread, (B, S, H, L, P))
        loc = (ref[None, :, None, None, None] + offsets / np.asarray(
            SHAPES, np.float64)[None, None, None, :, None]).astype(np.float32)
    attn = rng.rand(B, S, H, L, P).astype(np.float32)
    attn /= attn.sum((-1, -2), keepdims=True)
    grad_out = rng.randn(B, S, H * DH).astype(np.float32)
    return value, loc, attn, grad_out, margin


def jax_forward(value, loc, attn, margin):
    # not under one jit: XLA's CPU compiler would contract loc * T_l - 0.5
    # into an FMA, which moves the lerp fraction by an ulp of the tap
    # position (3e-5 at row 300) and, on a tie, a band start by a row
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jax_banded.ms_deform_attn_1d_banded(
            jnp.asarray(value), SHAPES, jnp.asarray(loc), jnp.asarray(attn),
            margin=margin))


def jax_grads(value, loc, attn, grad_out, margin):
    def loss(v, l, a):
        out = jax_banded.ms_deform_attn_1d_banded(v, SHAPES, l, a,
                                                  margin=margin)
        return jnp.sum(out * jnp.asarray(grad_out))

    with pltpu.force_tpu_interpret_mode():       # eager, as jax_forward
        return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
            jnp.asarray(value), jnp.asarray(loc), jnp.asarray(attn))]


def grads_close(got, want, keep=None):
    got, want = np.asarray(got), np.asarray(want)
    atol = 1e-5 * max(1.0, float(np.abs(want).max()))
    if keep is not None:
        got, want = got[keep], want[keep]
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=atol)


@pytest.mark.parametrize("margin", [0, 4, 32, 512])
@pytest.mark.parametrize("shapes", [SHAPES, (800, 400, 200, 100), (48, 24, 12)])
def test_band_sizes_match_jax(shapes, margin):
    pad = port.padded_shapes(shapes)
    assert all(p % 8 == 0 and 0 <= p - s < 8 for p, s in zip(pad, shapes))
    for Tq in shapes:
        assert port.band_sizes(pad, Tq, margin) == jax_banded._band_sizes(
            pad, Tq, margin)


def test_band_sizes_at_the_long_video_shapes():
    table = port.band_table((800, 400, 200, 100), 32)
    assert table == ((192, 128, 96, 88), (320, 192, 128, 104),
                     (576, 320, 192, 104), (800, 400, 200, 104))


def test_band_starts_match_jax_on_hand_made_taps(rng):
    """A query level of 300 (tiles of 128, 128 and 44 queries) tapping into
    levels padded 304, 152, 80, 40, with taps that pull the start below 0,
    past T_pad - BS and between multiples of 8."""
    Tq, margin = 300, 4
    pad = port.padded_shapes(SHAPES)
    bs = port.band_sizes(pad, Tq, margin)
    i0 = np.stack([rng.randint(lo, hi, (2, Tq, H, P)) for lo, hi in
                   ((-5, 300), (100, 150), (3, 75), (30, 38))], axis=3)
    i0[0, :128, 0, 0] = rng.randint(37, 60, (128, P))      # 37 -> start 32
    i0[0, 256:, 1, 0] = 299                                # the short tile
    got = port.band_starts(t(i0), t(np.asarray(pad)), t(np.asarray(bs)))
    assert got.shape == (2, 3, H, L)
    for b in range(2):
        for tile in range(3):
            for h in range(H):
                for l in range(L):
                    g = np.full((P, jax_banded._TQ), jax_banded._PAD_G,
                                np.int32)
                    rows = i0[b, tile * 128:(tile + 1) * 128, h, l].T
                    g[:, :rows.shape[1]] = rows
                    want = int(jax_banded._band_start(
                        jnp.asarray(g), jnp.asarray(g) + 1, pad[l], bs[l]))
                    assert int(got[b, tile, h, l]) == want, (b, tile, h, l)
    assert int(got[0, 0, 0, 0]) == 32
    assert int(got[0, 2, 1, 0]) == pad[0] - bs[0]


@pytest.mark.parametrize("kind", KINDS)
def test_plain_forward_matches_jax_banded_interpret(rng, kind):
    value, loc, attn, _, margin = world(kind, rng)
    want = jax_forward(value, loc, attn, margin)
    got = port.ms_deform_attn_1d_banded_ref(t(value), SHAPES, t(loc), t(attn),
                                            margin).numpy()
    np.testing.assert_allclose(got, want, **FWD_TOL)
    same_as_dense = np.allclose(
        got, dense.ms_deform_attn_1d_ref(t(value), SHAPES, t(loc),
                                         t(attn)).numpy(), **FWD_TOL)
    assert same_as_dense == (kind != "clamp")   # "clamp" does test the clamp


def test_band_clamp_only_lowers_rows_and_stays_inside_the_level(rng):
    """The TPU kernel pads each level with zero rows to a multiple of 8 and a
    band may cover them (here the coarsest queries' band into the level of 75
    has 80 rows), but no tap is read there: the band starts at or below
    every tap of the tile, so a clamped tap moves down, onto a real row."""
    value, loc, attn, _, margin = world("clamp", rng)
    g0, g1, _, _ = dense.prep_taps(SHAPES, t(loc), t(attn))
    r0, r1 = port.banded_rows(SHAPES, g0, g1, margin)
    assert bool((r0 <= g0).all()) and bool((r1 <= g1).all())
    assert bool((r1 < g1).any())                          # the clamp engaged
    starts = torch.tensor([0, 300, 450, 525])[:, None]
    assert bool((r0 >= starts).all())                     # never a level down
    assert port.band_table(SHAPES, margin)[3][2] == 80 > SHAPES[2]


@pytest.mark.parametrize("kind", KINDS)
def test_plain_backward_matches_jax_grad_of_banded(rng, kind):
    value, loc, attn, grad_out, margin = world(kind, rng)
    want = jax_grads(value, loc, attn, grad_out, margin)
    got = port.ms_deform_attn_1d_banded_bwd_ref(
        t(grad_out), t(value), SHAPES, t(loc), t(attn), margin)
    grads_close(got[0], want[0])
    grads_close(got[1], want[1], off_bounds(SHAPES, loc))
    grads_close(got[2], want[2])
    assert all(float(g.abs().max()) > 0 for g in got)


@pytest.mark.parametrize("kind", KINDS)
def test_autograd_of_plain_forward_matches_plain_backward(rng, kind):
    """The wrapper's CPU route (autograd of the plain forward) and the
    backward kernel's plain version give the same gradients: rtol 1e-4, atol
    1e-5 x max(1, max |want|), as tests/test_torch_ops_bwd.py holds the dense
    pair."""
    value, loc, attn, grad_out, margin = world(kind, rng)
    want = port.ms_deform_attn_1d_banded_bwd_ref(
        t(grad_out), t(value), SHAPES, t(loc), t(attn), margin)
    leaves = [t(x).requires_grad_() for x in (value, loc, attn)]
    out = port.ms_deform_attn_1d_banded(leaves[0], SHAPES, leaves[1],
                                        leaves[2], margin)
    got = torch.autograd.grad(out, leaves, t(grad_out))
    for g, w in zip(got, want):
        atol = 1e-5 * max(1.0, float(w.abs().max()))
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=atol)


def test_wrapper_on_cpu_runs_plain_and_launches_nothing(rng):
    value, loc, attn, _, margin = world("clamp", rng)
    fn = port.ms_deform_attn_1d_banded
    before = (fn.launches, fn.bwd_launches)
    got = fn(t(value).double(), SHAPES, t(loc), t(attn), margin)
    assert (fn.launches, fn.bwd_launches) == before
    assert got.dtype == torch.float64          # cast back to value's dtype
    want = port.ms_deform_attn_1d_banded_ref(t(value), SHAPES, t(loc), t(attn),
                                             margin)
    np.testing.assert_array_equal(got.float().numpy(), want.numpy())


def test_kernel_wrappers_refuse_cpu_tensors_and_other_queries(rng):
    value, loc, attn, grad_out, margin = world("local", rng)
    with pytest.raises(ValueError, match="kernel: value is on cpu"):
        port.ms_deform_attn_1d_banded_cuda(t(value), SHAPES, t(loc), t(attn))
    with pytest.raises(ValueError, match="kernel: value is on cpu"):
        port.ms_deform_attn_1d_banded_bwd_cuda(t(grad_out), t(value), SHAPES,
                                               t(loc), t(attn))
    with pytest.raises(ValueError, match="one query per token"):
        port.ms_deform_attn_1d_banded(t(value), SHAPES, t(loc[:, :30]),
                                      t(attn[:, :30]))


# ---- the host side of a kernel launch (kernel_plan), held on the CPU

YOUMAKEUP = (800, 400, 200, 100)
TINY_LONG = (300, 150, 75)
EIGHT_LEVELS = (1024, 512, 256, 128, 64, 32, 16, 8)


@pytest.mark.parametrize("Dh", [32, 64, 128])
@pytest.mark.parametrize("margin", [32, 4096])
@pytest.mark.parametrize("shapes", [YOUMAKEUP, TINY_LONG, EIGHT_LEVELS])
def test_kernel_plan_fits_the_shared_memory_of_a_block(shapes, margin, Dh):
    """Per tap of a tile of 128 queries: 16 bytes forward, 20 backward, 16
    more with grad_value, which also takes one counter per band row of the
    query level with the longest bands. All under the 232,448 bytes a block
    may take on sm_90, whatever the head width."""
    plan = port.kernel_plan(shapes, margin, 8, 4, Dh)
    taps = port.TILE_Q * len(shapes) * 4
    rows = max(sum(row) for row in port.band_table(shapes, margin))
    assert plan.shared_fwd == 16 * taps
    assert plan.shared_bwd_no_value == 20 * taps
    assert plan.shared_bwd == 36 * taps + 4 * rows
    assert plan.shared_fwd < plan.shared_bwd_no_value < plan.shared_bwd
    assert plan.shared_bwd <= port.MAX_SHARED_BYTES == 232448
    L = len(shapes)
    assert list(plan.shapes) == list(shapes)
    assert list(plan.bands) == [b for row in port.band_table(shapes, margin)
                                for b in row]
    assert len(plan.band_base) == L * (L + 1)


@pytest.mark.parametrize("margin", [0, 4, 32, 4096])
@pytest.mark.parametrize("shapes", [YOUMAKEUP, TINY_LONG, SHAPES,
                                    EIGHT_LEVELS])
def test_band_row_numbers_give_every_band_row_one_counter(shapes, margin, rng):
    """The backward kernel numbers the rows of a tile's L bands through and
    keeps one counter per number. Wherever the bands start, every band row
    gets a number of its own below the count, level after level; and a band
    may reach past its level (rows T_l .. T_pad - 1), which no tap names."""
    table = port.band_table(shapes, margin)
    pad = port.padded_shapes(shapes)
    numbers = port.band_row_numbers(table)
    assert list(port.kernel_plan(shapes, margin, 8, 4, 64).band_base) == [
        n for base in numbers for n in base]
    for sizes, base in zip(table, numbers):
        assert base[0] == 0 and base[-1] == sum(sizes)
        seen = []
        for l, bs in enumerate(sizes):
            start = 8 * rng.randint(0, (pad[l] - bs) // 8 + 1)
            assert 0 <= start <= pad[l] - bs
            rows = np.arange(start, start + bs)
            seen.append(base[l] + rows - start)
            assert seen[-1].min() == base[l]
            assert seen[-1].max() == base[l + 1] - 1
        seen = np.concatenate(seen)
        assert np.array_equal(np.sort(seen), np.arange(base[-1]))


def test_clamped_tap_rows_stay_inside_their_band_and_level(rng):
    """Every tap row the banded op reads lies in its tile's band and below
    T_l, so its counter exists and no row past a level is ever written."""
    value, loc, attn, _, margin = world("clamp", rng)
    g0, g1, _, _ = dense.prep_taps(SHAPES, t(loc), t(attn))
    r0, r1 = port.banded_rows(SHAPES, g0, g1, margin)
    starts = torch.tensor([0, 300, 450, 525])
    pad = torch.tensor(port.padded_shapes(SHAPES))
    numbers = port.band_row_numbers(port.band_table(SHAPES, margin))
    qs = 0
    for lq, Tq in enumerate(SHAPES):
        bs = torch.tensor(port.band_sizes(port.padded_shapes(SHAPES), Tq,
                                          margin))
        l0 = g0[:, qs:qs + Tq] - starts[:4, None]
        s = port.band_starts(l0, pad, bs).repeat_interleave(
            port.TILE_Q, dim=1)[:, :Tq, :, :, None]
        base = torch.tensor(numbers[lq])
        for r in (r0, r1):
            local = r[:, qs:qs + Tq] - starts[:4, None]
            assert bool((local < torch.tensor(SHAPES)[:, None]).all())
            number = base[:4, None] + local - s
            assert bool((number >= base[:4, None]).all())
            assert bool((number < base[1:, None]).all())
        qs += Tq


@pytest.mark.parametrize("shapes,P,H,Dh,match", [
    (YOUMAKEUP, 4, 8, 6, "head width 6"),
    (YOUMAKEUP, 4, 8, 2, "head width 2"),
    (YOUMAKEUP, 4, 8, 256, "head width 256"),
    ((64,) * 9, 4, 8, 64, "9 levels"),
    (YOUMAKEUP, 200, 8, 64, "4 levels x 200 points"),
    ((2 ** 20,) * 8, 4, 64, 128, "32-bit row offsets"),
    (EIGHT_LEVELS, 16, 8, 64, "bytes of shared memory"),
])
def test_kernel_plan_refuses_what_the_kernels_do_not_take(shapes, P, H, Dh,
                                                          match):
    with pytest.raises(ValueError, match=match):
        port.kernel_plan(shapes, 32, H, P, Dh)


@pytest.mark.parametrize("case", ["head width", "value alignment",
                                  "grad_out alignment"])
def test_plan_of_a_launch_reads_the_tensors_metadata(case):
    """The wrappers' size and alignment checks need no CUDA tensor."""
    S, L, P = sum(TINY_LONG), len(TINY_LONG), 4
    Dh = 6 if case == "head width" else 8
    value = torch.zeros(1 * S * 2 * Dh + 1)
    off = 1 if case == "value alignment" else 0
    value = value[off:off + S * 2 * Dh].view(1, S, 2, Dh)
    grad_out = torch.zeros(S * 2 * Dh + 1)
    off = 1 if case == "grad_out alignment" else 0
    grad_out = grad_out[off:off + S * 2 * Dh].view(1, S, 2 * Dh)
    loc = torch.zeros(1, S, 2, L, P)
    match = {"head width": "head width 6",
             "value alignment": "value is not 16-byte aligned",
             "grad_out alignment": "grad_out is not 16-byte aligned"}[case]
    with pytest.raises(ValueError, match=match):
        port._plan_for(value, TINY_LONG, loc, 32, grad_out)
    good = port._plan_for(torch.zeros(1, S, 2, 8), TINY_LONG, loc, 32,
                          torch.zeros(1, S, 16))
    assert good is port.kernel_plan(TINY_LONG, 32, 2, P, 8)
