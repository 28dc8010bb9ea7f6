"""Linear assignment (Hungarian matching) for the set criterion.

Port of gvl_tpu/train/lap.py by its exact oracle, `lap_scipy_callback`
(lap.py:144-164): the stacked cost goes to the host in one copy and
scipy.optimize.linear_sum_assignment solves each problem on its real columns.
The JAX package's on-device Jonker-Volgenant solver (lap.py:28-132) gives the
same optimal cost and may permute equal-cost assignments; it is not ported.

Shapes: cost (N, R, C), rows = queries, columns = GT events; each problem
has at most R valid columns.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def batched_lap(cost: torch.Tensor,
                col_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """cost (N, R, C) -> col_to_row (N, C) int64 on cost's device: the row
    assigned to each column in a min-cost one-to-one assignment. col_valid
    (N, C) bool leaves the columns where it is false out of the solve (any
    subset, as the JAX package's col_valid: the SCST matcher tiles the GT
    mask, so its valid columns are not a prefix); their slots hold -1.
    Synchronises the device (one copy of the cost to the host, one of the
    result back)."""
    from scipy.optimize import linear_sum_assignment

    N, R, C = cost.shape
    cost_np = cost.detach().float().cpu().numpy()
    valid_np = (np.ones((N, C), bool) if col_valid is None
                else col_valid.cpu().numpy().astype(bool))
    if (valid_np.sum(-1) > R).any():
        raise ValueError(f"batched_lap needs valid cols <= rows, got cost "
                         f"shape ({R}, {C}) and up to "
                         f"{int(valid_np.sum(-1).max())} valid columns; "
                         "check num_queries >= max GT events")
    out = np.full((N, C), -1, np.int64)
    for n in range(N):
        cols = np.nonzero(valid_np[n])[0]
        if len(cols):
            rows, sel = linear_sum_assignment(cost_np[n][:, cols])
            out[n, cols[sel]] = rows
    return torch.from_numpy(out).to(cost.device)
