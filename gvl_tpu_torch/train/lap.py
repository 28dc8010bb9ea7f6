"""Linear assignment (Hungarian matching) for the set criterion.

Port of gvl_tpu/train/lap.py by its exact oracle, `lap_scipy_callback`
(lap.py:144-164): the stacked cost goes to the host in one copy and
scipy.optimize.linear_sum_assignment solves each problem on its real columns.
The JAX package's on-device Jonker-Volgenant solver (lap.py:28-132) gives the
same optimal cost and may permute equal-cost assignments; it is not ported.

Shapes: cost (N, R, C), rows = queries, columns = GT events, C <= R.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def batched_lap(cost: torch.Tensor,
                col_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """cost (N, R, C) -> col_to_row (N, C) int64 on cost's device: the row
    assigned to each column in a min-cost one-to-one assignment. col_valid
    (N, C) bool, true on a prefix of each row, leaves padded columns out of
    the solve; their slots hold -1. Synchronises the device (one copy of the
    cost to the host, one of the result back)."""
    from scipy.optimize import linear_sum_assignment

    N, R, C = cost.shape
    if C > R:
        raise ValueError(f"batched_lap needs cols <= rows, got cost shape "
                         f"({R}, {C}); check num_queries >= max GT events")
    cost_np = cost.detach().float().cpu().numpy()
    if col_valid is None:
        sizes = np.full((N,), C)
    else:
        valid_np = col_valid.cpu().numpy().astype(bool)
        sizes = valid_np.sum(-1)
        if (valid_np != (np.arange(C)[None, :] < sizes[:, None])).any():
            raise ValueError("batched_lap: col_valid must be true on a "
                             "prefix of the columns")
    out = np.full((N, C), -1, np.int64)
    for n in range(N):
        c = int(sizes[n])
        if c:
            rows, cols = linear_sum_assignment(cost_np[n, :, :c])
            out[n, cols] = rows
    return torch.from_numpy(out).to(cost.device)
