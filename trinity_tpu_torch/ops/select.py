"""Exact top-C2 candidate selection by (bound desc, docid asc).

Counterpart of ``trinity_tpu/ops/select.py``, for its contract only. The
reference avoided a large-domain ``lax.top_k``, element gathers and XLA
scatters (each slow on the TPU) with a slot-major two-level lookup; on the
GPU a cumulative sum, one scatter and ``torch.gather`` do the same job,
without a host round trip.
"""

from __future__ import annotations

import math

import torch


def compact_mask(kept: torch.Tensor, C2: int, out=None):
    """Compact a (B, N) bool mask into (B, C2) member indices in ascending
    order. Returns (ki (B, C2) i32, valid (B, C2) bool); slots past the
    count are invalid and hold index 0. out: (ki (B, C2 + 1) i32, valid
    (B, C2) bool) to write into (e.g. views of a workspace); ki is then
    the first C2 columns of out[0]."""
    B, N = kept.shape
    dev = kept.device
    rank = torch.cumsum(kept.to(torch.int64), dim=1)  # inclusive
    slot = torch.where(kept & (rank <= C2), rank - 1, C2)  # C2 = discard
    if out is None:
        ki = torch.zeros((B, C2 + 1), dtype=torch.int32, device=dev)
        valid = torch.empty((B, C2), dtype=torch.bool, device=dev)
    else:
        ki, valid = out
        ki.zero_()
    ki.scatter_(1, slot, torch.arange(N, dtype=torch.int32,
                                      device=dev).expand(B, N))
    torch.lt(torch.arange(C2, device=dev)[None, :], rank[:, -1:], out=valid)
    # slots past the count were never written: they still hold 0
    return ki[:, :C2], valid


def gather_cols(arr: torch.Tensor, ki: torch.Tensor) -> torch.Tensor:
    """arr[..., ki] along the last axis (leading dims match)."""
    return torch.gather(arr, -1, ki.to(torch.int64))


def bound_select_candidates(bound: torch.Tensor, C2: int, vmax: int,
                            assume_no_overflow: bool = False, out=None):
    """Exact top-C2 selection by (bound desc, docid asc).

    bound: (B, N) tensor of integer values in [0, vmax]; 0 means
    non-candidate. out: compact_mask's, for ki and valid.
    Returns (ki (B, C2) i32 docids ascending, valid (B, C2) bool, tau (B,)
    i32, overflow (B,) bool). The selected set equals the top C2 by (bound
    desc, docid asc). When a row overflows, tau is the MAXIMUM UNPULLED
    bound, so `kth_score > score(tau)` proves the pulled set holds the true
    top-k. assume_no_overflow: the caller proves count(bound > 0) <= C2;
    tau is then 0 and selection is a docid-order compaction of bound > 0.
    """
    B, _ = bound.shape
    dev = bound.device
    if assume_no_overflow:
        ki, valid = compact_mask(bound > 0, C2, out)
        z = torch.zeros(B, dtype=torch.int32, device=dev)
        return ki, valid, z, z > 0
    # tau = max{v : count(bound >= v) > C2}: binary search with the
    # invariant count(bound >= lo) > C2 >= count(bound >= hi)
    lo = torch.zeros(B, dtype=torch.int64, device=dev)
    hi = torch.full((B,), vmax + 1, dtype=torch.int64, device=dev)
    for _ in range(max(1, math.ceil(math.log2(vmax + 2)))):
        mid = (lo + hi) // 2
        gt = (bound >= mid[:, None]).sum(dim=1) > C2
        lo = torch.where(gt, mid, lo)
        hi = torch.where(gt, hi, mid)
    tau = lo
    overflow = tau > 0
    # all of bound > tau, then the docid-first C2 - n_above of bound == tau
    above = bound > tau[:, None]
    lim = torch.where(overflow, C2 - above.sum(dim=1), -1)
    eq = bound == tau[:, None]
    kept = above | (eq & (torch.cumsum(eq.to(torch.int64), dim=1)
                          <= lim[:, None]))
    ki, valid = compact_mask(kept, C2, out)
    return ki, valid, tau.to(torch.int32), overflow
