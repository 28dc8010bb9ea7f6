"""Sequence-parallel context: the port of gvl_tpu/parallel/sp.py:21-64.

The train loop (or a test) sets the context on a world split into dp x sp
(`make_mesh_for_batch(B, 'dp,sp')`); `MSDeformAttn1D` reads it and routes
every deformable attention through gvl_tpu_torch/ops/ms_deform_attn_sp.py,
before the banded route, as in JAX (gvl_tpu/models/layers.py:124-147).
Without an sp axis (or at sp 1) `set_sp_context` sets nothing.

JAX's partitioner (GSPMD) shards the rest of its step implicitly; the port
has none, so it states which of its tensors are cut over sp. The split of
the step, for each row block (dp rank) and its two sp ranks:
- the base encoder (the conv pyramid), the level flattening, the masks and
  positions run on the whole frame axis on both sp ranks: a cut there
  would need conv halos;
- each sp rank then keeps its per-level chunks of the tokens (JAX's `_plan`
  layout: each level padded to a multiple of sp, chunk `sp_rank` of each,
  level-major) through the deformable encoder layers: the self-attention in
  'tokens' mode (halos exchanged over the sp group), FFN, norms, positions,
  masks and reference points all on the chunks (models/transformer.py
  `DeformableEncoder`);
- the encoder's memory is gathered over sp once (`gather_sp`: its backward
  sums the gradient over sp and keeps the rank's slice), back into the
  level-major order and unpadded, for its whole-memory consumers: the
  decoder, the LSTM-DSA sampled values and the text side;
- every decoder cross-attention (and the transformer caption head's) runs
  in 'replicated' mode on the rank's chunk of its value: the weights of the
  taps outside the chunk are zeroed and the partial outputs summed over sp
  (`sum_sp`, whose backward sums too). It is exact;
- everything after the encoder but those cross-attentions is replicated on
  both sp ranks of a row block.

The gradient rule: summing every gradient over all W ranks
(`sum_gradients`) gives the global batch's. Each rank's loss is its dp
share of the global loss times 1/sp (`parallel.loss_scale`, also without
a context: both sp ranks then run the whole step), so a replicated part
contributes its share once over its sp ranks; a part cut over sp reaches
its slices through the collectives' adjoints above; `global_sum`
denominators count each row once (over the dp group). Random draws agree
within an sp group: the step's seed is folded with the dp index, not the
rank (train/state.py `rank_seed`).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class SpContext:
    """The sp ranks of this rank (`world`, a split gvl_tpu_torch.parallel
    World), the halo width as a fraction of each padded level, and whether
    each encoder sp call counts the taps its halo clamp moved
    (`clamp_monitor`; read by `halo_clamped`)."""
    world: Any
    halo_frac: float = 0.125
    clamp_monitor: bool = False

    @property
    def sp(self) -> int:
        return int(self.world.sp_size)

    @property
    def sp_rank(self) -> int:
        return int(self.world.sp_rank)


_CTX: Optional[SpContext] = None


def set_sp_context(world: Any, halo_frac: float = 0.125,
                   clamp_monitor: bool = False) -> Optional[SpContext]:
    """Route the deformable attention of later forwards through the sp op
    on `world`'s sp ranks. world None, or a world without an sp axis (sp
    1), sets no context and returns None."""
    global _CTX
    if world is None or int(getattr(world, "sp_size", 1)) <= 1:
        _CTX = None
    else:
        _CTX = SpContext(world, float(halo_frac), bool(clamp_monitor))
    return _CTX


def get_sp_context() -> Optional[SpContext]:
    return _CTX


@contextlib.contextmanager
def sp_context(world: Any, **kw):
    """`set_sp_context(world, **kw)` inside the block; the context before
    it afterwards."""
    global _CTX
    prev = _CTX
    try:
        yield set_sp_context(world, **kw)
    finally:
        _CTX = prev


def halo_clamped(module) -> int:
    """The taps the halo clamp moved in the last forward of every
    deformable attention under `module` that counted them (clamp_monitor),
    summed over all ranks: 0 means the sp output is exact. The counterpart
    of the 'sp_debug/halo_clamped' sow (gvl_tpu/models/layers.py:141-147);
    one all_reduce over the world."""
    import torch

    from gvl_tpu_torch import parallel as dp
    counts = [m.halo_clamped for m in module.modules()
              if getattr(m, "halo_clamped", None) is not None]
    if not counts:
        return 0
    total = torch.stack([c.to(torch.float64) for c in counts]).sum()
    return int(dp.mesh._all_reduce(total.clone()).item()
               if dp.world().group is not None else total.item())
