"""Linear sum assignment (rectangular Hungarian / Jonker-Volgenant) in torch
ops, batched, on the cost tensor's device.

Parity target: mesm_tpu/ops/lsap.py:33-118 (the e-maxx shortest augmenting
path with dual potentials). The reference ships every cost matrix to the
CPU and calls scipy.optimize.linear_sum_assignment per sample (reference
model/matcher.py:106-117); here the whole batch is solved in lock step with
no host synchronisation: the loops have static trip counts (inserting row i
takes at most i Dijkstra steps and an augmenting path of at most i edges),
and a sample whose search has ended is held by a mask. The arithmetic is
the JAX solver's, in float32, in the same order, so the assignments are
equal; ties go to the first column, as jnp.argmin's do.

Sizes are tiny (rows = targets <= 5, columns = queries = 10): the loops
cost a few hundred small launches per call, and no host round trip.

Conventions:
  - cost: (B, n, m) with n <= m. Each row is assigned a distinct column.
  - Variable row counts are handled by padding invalid rows with a constant
    cost: a constant row cannot change which columns the valid rows get.
"""
from __future__ import annotations

from typing import Optional

import torch

_INF = 1e30
_BIG = 1e6


@torch.no_grad()
def solve_lsap_batch(cost: torch.Tensor, row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Min-cost assignment of each (n, m) matrix of a (B, n, m) batch, n <= m.

    row_mask: optional (B, n) bool; False rows take a constant cost (their
    returned column is meaningless and must be masked by the caller).
    Returns col4row: (B, n) int64, the column of each row; restricted to the
    valid rows, the assignment is optimal and equals scipy's."""
    B, n, m = cost.shape
    if n > m:
        raise ValueError(f"solve_lsap_batch requires n <= m, got {tuple(cost.shape)}")
    dev = cost.device
    cost = cost.float()
    if row_mask is not None:
        cost = torch.where(row_mask.bool()[:, :, None], cost, torch.full_like(cost, _BIG))
    rows = torch.arange(B, device=dev)
    zero = torch.zeros((), device=dev)
    u = torch.zeros(B, n + 1, device=dev)
    v = torch.zeros(B, m + 1, device=dev)
    p = torch.zeros(B, m + 1, dtype=torch.long, device=dev)  # row matched to column j (0 = none)
    for i in range(1, n + 1):
        p[:, 0] = i
        minv = torch.full((B, m + 1), _INF, device=dev)
        way = torch.zeros(B, m + 1, dtype=torch.long, device=dev)
        used = torch.zeros(B, m + 1, dtype=torch.bool, device=dev)
        j0 = torch.zeros(B, dtype=torch.long, device=dev)
        active = torch.ones(B, dtype=torch.bool, device=dev)
        for _ in range(i):  # Dijkstra steps: column 0, then at most i - 1 matched columns
            act = active[:, None]
            used = used | (act & (torch.arange(m + 1, device=dev)[None] == j0[:, None]))
            i0 = p[rows, j0]
            cur = cost[rows, i0 - 1, :] - u[rows, i0][:, None] - v[:, 1:]
            better = act & ~used[:, 1:] & (cur < minv[:, 1:])
            minv[:, 1:] = torch.where(better, cur, minv[:, 1:])
            way[:, 1:] = torch.where(better, j0[:, None], way[:, 1:])
            reach = torch.where(used[:, 1:], torch.full_like(cur, _INF), minv[:, 1:])
            j1 = torch.argmin(reach, dim=1) + 1
            delta = reach[rows, j1 - 1]
            # dual update: the used columns' rows gain delta, the used columns
            # lose it, the unused columns' tentative distances shrink by it
            step = torch.where(act & used, delta[:, None], zero)
            u = u.scatter_add(1, p, step)
            v = v - step
            minv = torch.where(act & ~used, minv - delta[:, None], minv)
            j0 = torch.where(active, j1, j0)
            active = active & (p[rows, j0] != 0)
        for _ in range(i):  # walk the augmenting path back, flipping matched edges
            going = j0 != 0
            j1 = way[rows, j0]
            p[rows, j0] = torch.where(going, p[rows, j1], p[rows, j0])
            j0 = torch.where(going, j1, j0)
    # invert the column -> row matching into row -> column
    matched = p[:, 1:]  # (B, m), 0 = unmatched column
    slot = torch.where(matched > 0, matched - 1, torch.full_like(matched, n))
    col4row = torch.zeros(B, n + 1, dtype=torch.long, device=dev)
    col4row.scatter_(1, slot, torch.arange(m, device=dev).expand(B, m).contiguous())
    return col4row[:, :n]


def solve_lsap(cost: torch.Tensor, row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """solve_lsap_batch for one (n, m) matrix [+ (n,) mask] -> (n,)."""
    return solve_lsap_batch(cost[None], None if row_mask is None else row_mask[None])[0]
