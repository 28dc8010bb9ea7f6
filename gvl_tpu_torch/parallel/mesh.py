"""Data parallelism over ranks: the port's counterpart of
gvl_tpu/parallel/mesh.py (`make_mesh_for_batch` :45-61, `shard_batch`
:64-85, `replicate_tree` :88-90) and of the 'dp' collectives that XLA
derives there from the global batch.

The JAX package runs one process over a mesh of devices and computes its
one-device step on the global batch (tests/test_sharding_consistency.py).
The port runs one process per card, started by a launcher:

    python -m torch.distributed.run --nproc_per_node N \\
        -m gvl_tpu_torch.train_cli --cfg_path X.yml [...]

`init_distributed` reads the launcher's environment (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and joins the process group: NCCL on
cards, gloo on the CPU, every collective under a timeout of `timeout_s`
seconds (TIMEOUT_S by default), so that a dead rank ends the run instead of
hanging it. Without that environment the world is one rank, no group
exists and every helper below is the identity, so a run that is not
launched computes what it computed before.

The rules, which together give JAX's global-batch step:
- rows: rank r of W takes rows [r B/W, (r+1) B/W) of every global batch
  (`shard_batch`), the block shard_batch places on device r; every rank
  builds the same seeded Batcher. A batch that W does not divide is
  refused (`make_mesh_for_batch`).
- shares: each rank's loss is its exact share of the global-batch loss:
  it sums over its own rows and divides by a count over the global batch
  (`global_sum`); the gradients are then summed across ranks
  (`sum_gradients`), never averaged, so no factor of W appears.
- cross-video terms read the other ranks' rows through `gather_rows`, whose
  backward sums the gathered gradient across ranks and keeps the rank's
  own slice: under the shares above that is the global gradient.
- one writer: rank 0 writes files (`is_writer`); the others read them.

Sequence parallelism (mesh_shape 'dp,sp', mesh.py:28-42): at W >= 4 ranks,
W even, `make_mesh_for_batch` splits the world into a dp x sp grid with
sp = 2: rank r is device r of JAX's `reshape(W // 2, 2)`, dp index r // 2
and sp index r % 2 (`World.dp_rank`, `.sp_rank`). Every rank makes every
sub-group (`dist.new_group`), in one order: the dp groups (the ranks of one
sp index) and the sp groups (the two ranks of one dp index). The rows
follow the dp index, so both ranks of an sp group hold the same rows, and
the rules above hold over the dp group: `row_block`, `shard_batch`,
`global_sum` (each row counted once), `gather_rows` and `sum_shares`; the
gradients are summed over the whole world (`sum_gradients`). The sp group's
own collectives are `gather_sp` and `sum_sp` (gvl_tpu_torch/parallel/sp.py
says how the step is split over it). A world of W < 4 or an odd W asked for
'dp,sp' is plain dp, as in JAX.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

# seconds a collective may wait for the other ranks before the run fails
TIMEOUT_S = 1800
# bytes of gradient per all_reduce in `sum_gradients`
BUCKET_BYTES = 64 * 2 ** 20


class World:
    """The ranks of a run: this process's `rank` of `size`, the process
    `group` (None: no collectives at all) and the `device` that holds the
    group's host-side tensors. Split into dp x sp (`split_sp`): this rank's
    `dp_rank` of `dp_size` rows blocks and `sp_rank` of `sp_size`, the
    `dp_group` of the ranks that share its sp index and the `sp_group` of
    those that share its rows (None at sp_size 1); unsplit, the dp group is
    the whole world."""

    def __init__(self, rank: int = 0, size: int = 1, group: Any = None,
                 device: str = "cpu", owned: bool = False,
                 timeout_s: float = TIMEOUT_S):
        self.rank, self.size = rank, size
        self.group, self.device = group, torch.device(device)
        self.owned = owned          # init_distributed made the group
        self.timeout_s = timeout_s
        self.dp_rank, self.dp_size, self.dp_group = rank, size, group
        self.sp_rank, self.sp_size, self.sp_group = 0, 1, None

    def split_sp(self, sp: int) -> None:
        """Split into a dp x sp grid (rank = dp_rank * sp + sp_rank): every
        rank makes every sub-group, in the same order."""
        dp_size = self.size // sp
        dp_groups = [dist.new_group(list(range(s, self.size, sp)),
                                    timeout=datetime.timedelta(
                                        seconds=self.timeout_s))
                     for s in range(sp)]
        sp_groups = [dist.new_group(list(range(d * sp, (d + 1) * sp)),
                                    timeout=datetime.timedelta(
                                        seconds=self.timeout_s))
                     for d in range(dp_size)]
        self.dp_rank, self.sp_rank = divmod(self.rank, sp)
        self.dp_size, self.sp_size = dp_size, sp
        self.dp_group = dp_groups[self.sp_rank]
        self.sp_group = sp_groups[self.dp_rank]

    def __repr__(self):
        if self.sp_size > 1:
            return (f"World(rank={self.rank}, size={self.size}, dp "
                    f"{self.dp_rank}/{self.dp_size}, sp "
                    f"{self.sp_rank}/{self.sp_size})")
        return f"World(rank={self.rank}, size={self.size})"


_world = World()


def world() -> World:
    return _world


def rank() -> int:
    return _world.rank


def size() -> int:
    return _world.size


def is_writer() -> bool:
    """Whether this rank writes the run's files (rank 0)."""
    return _world.rank == 0


def init_distributed(device: str = "cuda", backend: Optional[str] = None,
                     timeout_s: float = TIMEOUT_S) -> World:
    """The world of this process. Under a launcher (WORLD_SIZE in the
    environment, also a world of one) join its process group, or adopt one
    made already: NCCL for device 'cuda' and gloo for 'cpu' unless
    `backend` says otherwise, every collective failing after `timeout_s`
    seconds; on a card the current device becomes cuda:LOCAL_RANK. Without
    a launcher, a world of one rank and no group."""
    global _world
    if _world.group is not None:
        return _world
    owned = False
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            return _world
        if device == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(
            backend or ("nccl" if device == "cuda" else "gloo"),
            init_method="env://", rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]),
            timeout=datetime.timedelta(seconds=timeout_s))
        owned = True
    dev = (f"cuda:{torch.cuda.current_device()}"
           if dist.get_backend() == "nccl" else "cpu")
    _world = World(dist.get_rank(), dist.get_world_size(), dist.group.WORLD,
                   dev, owned, timeout_s)
    return _world


def shutdown() -> None:
    """Leave the process group init_distributed made, and the world."""
    global _world
    if _world.owned:
        dist.destroy_process_group()
    _world = World()


@contextlib.contextmanager
def local():
    """A world of one rank, without a group, inside the block: the
    collectives below become the identity (rank 0 evaluating alone while
    the others wait)."""
    global _world
    saved, _world = _world, World()
    try:
        yield
    finally:
        _world = saved


# ------------------------------------------------------------------ batches

def check_divides(batch_size: int, n: int) -> None:
    """Raises unless `n` ranks divide a global batch of `batch_size` rows,
    naming the world sizes that would divide it."""
    if batch_size % n:
        fits = [k for k in range(1, batch_size + 1) if batch_size % k == 0]
        raise ValueError(
            f"data parallel: the global batch of {batch_size} rows does not "
            f"divide over {n} ranks; launch a world of one of {fits} ranks "
            "or pick a batch that it divides")


def make_mesh_for_batch(batch_size: int, shape: str = "dp") -> World:
    """The world that shards a global batch of `batch_size` rows
    (mesh.py:45-61). JAX leaves the devices that do not divide the batch
    idle; a launcher's ranks cannot idle, so a batch that the world does
    not divide is refused, naming the world sizes that would divide it.
    With shape 'dp,sp' (or 'dp_sp') a world of W >= 4 ranks, W even, is
    split into dp x sp with sp = 2 (mesh.py:28-42, once: a world split
    already stays so); a smaller or odd world is plain dp, as in JAX, and
    so is any world with shape 'dp'."""
    W = _world.size
    check_divides(batch_size, W)
    if shape == "dp" or W < 4:
        return _world
    if shape not in ("dp,sp", "dp_sp"):
        raise ValueError(f"unknown mesh shape {shape}")
    if W % 2 == 0 and _world.sp_size == 1:
        _world.split_sp(2)
    return _world


def loss_scale() -> float:
    """The factor of each rank's loss before its backward: 1/sp, since both
    ranks of an sp group hold their row block's whole loss (1 unsplit; see
    gvl_tpu_torch/parallel/sp.py)."""
    return 1.0 / _world.sp_size


def row_block(n_rows: int) -> slice:
    """This rank's rows of a global batch of `n_rows` (mesh.py:64-85,
    P('dp') over the batch axis): by its dp index, so both ranks of an sp
    group take the same rows."""
    per = n_rows // _world.dp_size
    return slice(_world.dp_rank * per, (_world.dp_rank + 1) * per)


def shard_batch(batch: Dict, n_rows: Optional[int] = None) -> Dict:
    """This rank's block of a global batch: every array or tensor cut on
    its first axis and every list sliced, by `row_block` of `n_rows` (the
    batch's first array's length when None). A list shorter than the batch
    (the real keys of a padded eval batch) keeps its entries in the block.
    The batch itself without dp ranks to share it."""
    if _world.dp_size == 1:
        return batch
    if n_rows is None:
        n_rows = next(len(v) for v in batch.values()
                      if isinstance(v, (np.ndarray, torch.Tensor)))
    sl = row_block(n_rows)
    return {k: v[sl] if isinstance(v, (np.ndarray, torch.Tensor, list,
                                       tuple)) else v
            for k, v in batch.items()}


# -------------------------------------------------------------- collectives

def _all_reduce(x: torch.Tensor, group: Any = None) -> torch.Tensor:
    dist.all_reduce(x, op=dist.ReduceOp.SUM,
                    group=_world.group if group is None else group)
    return x


def global_sum(x):
    """The sum over the dp ranks of `x`, a count or a sum over this rank's
    rows (a tensor without gradient, or a number): every denominator that
    counts over the batch goes through it, each row counted once (the sp
    ranks of a row block hold the same rows). The identity without a
    group."""
    if _world.group is None:
        return x
    if isinstance(x, torch.Tensor):
        return _all_reduce(x.detach().clone(), _world.dp_group)
    return type(x)(_all_reduce(torch.tensor(
        float(x), dtype=torch.float64, device=_world.device),
        _world.dp_group).item())


def sum_shares(losses: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The global values of a dict of 0-d loss shares, in one all_reduce
    over the dp ranks: rank 0 logs JAX's global numbers. The dict itself
    without a group."""
    if _world.group is None or not losses:
        return losses
    keys = list(losses)
    flat = _all_reduce(torch.stack([losses[k].detach().float()
                                    for k in keys]), _world.dp_group)
    return dict(zip(keys, flat.unbind()))


class _GatherRows(torch.autograd.Function):
    """all_gather on the first axis, in rank order; backward: the gathered
    gradient summed over ranks, then this rank's slice."""

    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.group, ctx.rank, ctx.n = group, rank, x.shape[0]
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad[ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n], None, None, None


def _gather(x: torch.Tensor, group: Any, rank: int, size: int
            ) -> torch.Tensor:
    if x.requires_grad:
        return _GatherRows.apply(x, group, rank, size)
    src = x.to(torch.uint8) if x.dtype == torch.bool else x
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src.contiguous(), group=group)
    out = torch.cat(parts)
    return out.bool() if x.dtype == torch.bool else out


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every dp rank's `x` (the same shape on each) concatenated on the
    first axis in dp order: the global batch's rows, JAX's row order. Under
    autograd the gradient reaching each rank's rows is the sum of every dp
    rank's loss gradient there. `x` itself without a group."""
    if _world.group is None:
        return x
    return _gather(x, _world.dp_group, _world.dp_rank, _world.dp_size)


def gather_sp(x: torch.Tensor) -> torch.Tensor:
    """Every sp rank's `x` (the same shape on each) stacked on a new first
    axis in sp order; under autograd the gradient reaching each rank's `x`
    is the sum over the sp ranks of the gradient at its slot (the
    all-gather's adjoint). x[None] without an sp group."""
    if _world.sp_group is None:
        return x[None]
    return _gather(x[None], _world.sp_group, _world.sp_rank, _world.sp_size)


class _SumSp(torch.autograd.Function):
    """all_reduce(SUM) over the sp group; backward: the same sum of the
    gradients (each rank's replicated consumers hold their share of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.contiguous().clone(), ctx.group), None


def sum_sp(x: torch.Tensor) -> torch.Tensor:
    """The sum over the sp ranks of `x` (the same shape on each), on every
    one of them; its gradient is summed over them likewise. `x` itself
    without an sp group."""
    if _world.sp_group is None:
        return x
    if x.requires_grad:
        return _SumSp.apply(x, _world.sp_group)
    return _all_reduce(x.contiguous().clone(), _world.sp_group)


def sum_gradients(params: Iterable[torch.Tensor],
                  bucket_bytes: int = BUCKET_BYTES) -> None:
    """Sum the gradients of `params` over ranks, in place: one flat
    all_reduce(SUM) per bucket of `bucket_bytes`. A parameter without a
    gradient on some rank enters as zeros on that rank, so every rank makes
    the same collectives; one without a gradient on every rank keeps none,
    as at W = 1 (a flag per parameter rides in the last bucket). A no-op
    without a group."""
    if _world.group is None:
        return
    params = [p for p in params if p.requires_grad]
    if not params:
        return
    flat = [p.grad if p.grad is not None else torch.zeros_like(p)
            for p in params]
    flat.append(torch.tensor([float(p.grad is not None) for p in params],
                             dtype=flat[0].dtype, device=flat[0].device))
    buckets: List[List[int]] = [[]]
    nbytes = 0
    for i, g in enumerate(flat):
        size_i = g.numel() * g.element_size()
        if buckets[-1] and (nbytes + size_i > bucket_bytes
                            or g.dtype != flat[buckets[-1][0]].dtype):
            buckets.append([])
            nbytes = 0
        buckets[-1].append(i)
        nbytes += size_i
    for idx in buckets:
        summed = _all_reduce(torch.cat([flat[i].reshape(-1) for i in idx]))
        for i, part in zip(idx, summed.split([flat[i].numel()
                                              for i in idx])):
            flat[i] = part.view_as(flat[i])
    for p, g, has in zip(params, flat, flat[-1].tolist()):
        p.grad = g if has > 0 else None


def all_gather_object(obj: Any, dp_only: bool = False) -> List[Any]:
    """Every rank's picklable `obj`, in rank order ([obj] without a
    group); with `dp_only`, every dp rank's, in dp order (each row block
    once)."""
    if _world.group is None:
        return [obj]
    group, n = ((_world.dp_group, _world.dp_size) if dp_only
                else (_world.group, _world.size))
    out: List[Any] = [None] * n
    dist.all_gather_object(out, obj, group=group)
    return out


def broadcast_object(obj: Any) -> Any:
    """Rank 0's `obj` on every rank (`obj` without a group)."""
    if _world.group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=_world.group)
    return box[0]


def barrier() -> None:
    """Wait for every rank, at most the group's timeout."""
    if _world.group is not None:
        dist.barrier(group=_world.group)


def replicate_tree(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers broadcast to every rank
    (mesh.py:88-90). Every rank seeded its init alike, so each checks that
    it held rank 0's values already; a rank that did not fails the run on
    every rank (a run launched with differing configs or code)."""
    if _world.group is None:
        return
    differ = []
    for name, t in list(module.named_parameters()) + list(
            module.named_buffers()):
        got = t.detach().clone()
        dist.broadcast(got, src=0, group=_world.group)
        if not torch.equal(got, t.detach()):
            differ.append(name)
    n = int(global_sum(len(differ)))
    if n:
        raise RuntimeError(
            f"data parallel: {n} initial tensors differ from rank 0's (here: "
            f"{differ[:3]}); every rank must start from the same seeded init")
