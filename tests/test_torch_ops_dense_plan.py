"""The dense deformable-attention op's library yardstick and the host side of
its kernels, on the CPU: `ms_deform_attn_1d_embedding_bag` against the plain
forward and backward, the backward kernel's launch plan (`bwd_plan`:
blocks, chunks, shared memory, refused sizes) and the refusals of
`check_kernel_inputs`. No JAX here.

Tolerance 1e-5 absolute / relative in f32: the library call sums the same
lerped taps as the plain version, lower rows first.
"""

import numpy as np
import pytest
import torch

from gvl_tpu_torch.ops import ms_deform_attn as port
from tests.test_torch_ops import KINDS, inputs, t

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_embedding_bag_matches_plain_forward_and_grad_value(rng, kind):
    value, shapes, loc, attn = inputs(kind, rng)
    want = port.ms_deform_attn_1d_ref(t(value), shapes, t(loc), t(attn))
    leaf = t(value).clone().requires_grad_()
    got = port.ms_deform_attn_1d_embedding_bag(leaf, shapes, t(loc), t(attn))
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), **TOL)
    grad_out = t(rng.randn(*want.shape).astype(np.float32))
    got.backward(grad_out)
    grad_value = port.ms_deform_attn_1d_bwd_ref(grad_out, t(value), shapes,
                                                t(loc), t(attn))[0]
    np.testing.assert_allclose(leaf.grad.numpy(), grad_value.numpy(), **TOL)


# ---- the host side of a backward launch (bwd_plan)

# (B, S, H, Lq, K): the main paths' shapes (flagship encoder and decoder,
# long-video decoder at B=4 and 8), the short pyramid of the tests with
# K = 6, a dense encoder over the long-video pyramid, eight levels of 64
# points, a single (b, h) of 5000 rows; then the edges: one row and one
# query, ranges of exactly 256 rows and of one more, chunks of exactly the
# byte budget's 213 queries and of one more, one query past 512 taps' chunk
SIZES = [(16, 188, 8, 188, 16), (16, 188, 8, 30, 16), (4, 1500, 8, 100, 16),
         (8, 1500, 8, 100, 16), (2, 525, 8, 70, 6), (1, 1500, 8, 1500, 16),
         (2, 2040, 8, 60, 512), (1, 5000, 1, 700, 16),
         (1, 1, 1, 1, 1), (3, 256, 2, 7, 16), (3, 257, 2, 7, 16),
         (2, 512, 4, 213, 16), (2, 513, 4, 214, 16), (1, 100, 8, 1, 4),
         (5, 188, 8, 427, 16), (1, 64, 8, 3, 512)]


@pytest.mark.parametrize("Dh", [32, 64, 128])
@pytest.mark.parametrize("sizes", SIZES)
def test_bwd_plan_covers_every_query_and_row_once(sizes, Dh):
    """Dot blocks cover the (b, q, h) 8 at a time; value blocks the (b, h) x
    ranges of at most 256 rows, no range empty, each walking all Lq queries.
    A value block sorts a chunk of its queries at a time in 32 bytes per tap
    and 4 per float of dOut, at most 160 KB unless one query takes more, and
    keeps 17 counters per row: under the 232,448 bytes a block may take."""
    B, S, H, Lq, K = sizes
    plan = port.bwd_plan(B, S, H, Dh, Lq, K)
    n_rr = -(-S // plan.rows)
    assert (n_rr - 1) * plan.rows < S <= n_rr * plan.rows
    assert plan.rows <= 256 and n_rr == -(-S // 256)
    assert plan.value_blocks == B * H * n_rr
    assert plan.dot_blocks * 8 >= B * Lq * H > (plan.dot_blocks - 1) * 8
    per_query = 32 * K + 4 * Dh
    assert 1 <= plan.chunk <= Lq
    assert plan.chunk * per_query <= max(160 * 1024, per_query)
    assert (plan.chunk == Lq
            or (plan.chunk + 1) * per_query > 160 * 1024)
    assert plan.shared == plan.chunk * per_query + 68 * plan.rows
    assert plan.shared <= port.MAX_SHARED_BYTES


@pytest.mark.parametrize("sizes,chunk,rows,value_blocks,dot_blocks", [
    ((16, 188, 8, 188, 16), 188, 188, 128, 3008),
    ((16, 188, 8, 30, 16), 30, 188, 128, 480),
    ((4, 1500, 8, 100, 16), 100, 250, 192, 400),
    ((8, 1500, 8, 100, 16), 100, 250, 384, 800),
    ((1, 1500, 8, 1500, 16), 213, 250, 48, 1500),
    ((1, 5000, 1, 700, 16), 213, 250, 20, 88),
])
def test_bwd_plan_gives_a_value_block_a_bh_and_its_rows(
        sizes, chunk, rows, value_blocks, dot_blocks):
    """A value block per (b, h) and range of at most 256 rows walks all Lq
    queries, at every main path's shape in one chunk (213 queries fit 160 KB
    at K = 16, Dh = 64)."""
    B, S, H, Lq, K = sizes
    plan = port.bwd_plan(B, S, H, 64, Lq, K)
    assert (plan.chunk, plan.rows, plan.value_blocks,
            plan.dot_blocks) == (chunk, rows, value_blocks, dot_blocks)


def test_bwd_plan_refuses_a_grid_past_its_limit():
    with pytest.raises(ValueError, match="blocks, past the grid"):
        port.bwd_plan(2 ** 20, 2 ** 20, 16, 64, 8, 4)


# ---- what check_kernel_inputs refuses, on the tensors' metadata

def tensors(Dh=8, P=4, shapes=(13, 7), H=2, Lq=5, offset=0):
    S = sum(shapes)
    flat = torch.zeros(S * H * Dh + offset)
    value = flat[offset:].view(1, S, H, Dh)
    loc = torch.zeros(1, Lq, H, len(shapes), P)
    return value, shapes, loc, loc.clone()


@pytest.mark.parametrize("kw,match", [
    (dict(Dh=6), "head width 6"),
    (dict(Dh=2), "head width 2"),
    (dict(Dh=516), "head width 516"),
    (dict(P=300), "2 levels x 300 points"),
    (dict(offset=1), "value is not 16-byte aligned"),
    (dict(shapes=(13, 7, 1, 1, 1, 1, 1, 1, 1)), "9 levels"),
    (dict(), "value is on cpu"),
])
def test_check_kernel_inputs_names_the_limit(kw, match):
    with pytest.raises(ValueError, match=match):
        port.check_kernel_inputs(*tensors(**kw))


def test_check_kernel_inputs_refuses_unaligned_grad_out_and_wide_batches():
    value, shapes, loc, attn = tensors()
    grad_out = torch.zeros(5 * 16 + 1)[1:].view(1, 5, 16)
    with pytest.raises(ValueError, match="grad_out is not 16-byte aligned"):
        port.check_kernel_inputs(value, shapes, loc, attn, grad_out)
    wide = torch.zeros(1).expand(1, 2 ** 21, 8, 128)
    loc = torch.zeros(1, 1, 8, 1, 4)
    with pytest.raises(ValueError, match="32-bit row offsets"):
        port.check_kernel_inputs(wide, (2 ** 21,), loc, loc)
