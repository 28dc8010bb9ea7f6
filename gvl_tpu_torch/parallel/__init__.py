"""Data and sequence parallelism over ranks (the port of
gvl_tpu/parallel/mesh.py and gvl_tpu/parallel/sp.py)."""

from gvl_tpu_torch.parallel.mesh import (  # noqa: F401
    all_gather_object, barrier, broadcast_object, check_divides, gather_rows,
    gather_sp, global_sum, init_distributed, is_writer, local, loss_scale,
    make_mesh_for_batch, rank, replicate_tree, row_block, shard_batch,
    shutdown, size, sum_gradients, sum_shares, sum_sp, world)
