"""Collectives over one tensor per place of a mesh, for one controller.

Where the JAX package leaves the collectives of a sharded step to XLA, the
port's one controller calls them itself between the shards' ops.  Each is
written as peer copies (``t.to(place, non_blocking=True)``) and adds on the
destination: one code path for the CPU, for a logical mesh whose places are
one card, and for distinct cards.  A copy to the device a tensor is on is
no copy, so on one card the collectives move nothing.

NCCL (``torch.cuda.nccl``) would overlap the copies of distinct cards; it
cannot be tested on a machine with one card and is not used.
"""

from __future__ import annotations

import torch


def broadcast(t: torch.Tensor, places) -> list:
    """``t`` on every place (the same tensor where a place is its device)."""
    return [t.to(place, non_blocking=True) for place in places]


def all_gather(parts, dim: int, place) -> torch.Tensor:
    """The parts, one per place, concatenated along ``dim`` on ``place``
    (where the whole is read: the first place of a dp rank or the mesh)."""
    return torch.cat([p.to(place, non_blocking=True) for p in parts], dim)


def all_reduce_sum(parts) -> list:
    """The sum of the parts in f32, on every part's place.  The parts are
    a tensor-parallel product's partial sums, each in f32: adding them in
    f32 and rounding once after (the caller's cast) differs from the
    unsharded product only in the order of an f32 sum."""
    total = parts[0].float()
    for p in parts[1:]:
        total = total + p.to(total.device, non_blocking=True).float()
    return broadcast(total, [p.device for p in parts])
