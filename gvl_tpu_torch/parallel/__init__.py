"""Data parallelism over ranks (the port of gvl_tpu/parallel/mesh.py)."""

from gvl_tpu_torch.parallel.mesh import (  # noqa: F401
    all_gather_object, barrier, broadcast_object, gather_rows,
    global_sum, init_distributed, is_writer, local, make_mesh_for_batch,
    rank, replicate_tree, row_block, shard_batch, shutdown, size,
    sum_gradients, sum_shares, world)
