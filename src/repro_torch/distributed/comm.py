"""The communication options of the distributed driver (`CommSpec`).
Counterpart of `repro.distributed.comm`, field for field.

One frozen node, carried on the `SimSpec` and on `DistConfig`, switching
the three mechanisms of the shard exchange:

* ``overlap_halo``: every first-hop halo slab is sliced from the raw local
  block, so no exchange depends on another's result (the corners route
  x-then-y as two hops of the corner block alone); the result is bit-equal
  to the serialized per-axis exchange;
* ``compress_migration``: migrating particles cross as shard-relative
  uint16 fixed-point positions and bfloat16 momenta, weights exact (total
  charge is conserved exactly): 16 bytes a row instead of 28;
* ``rebalance_enable``: the window halts with ``HALT_IMBALANCE`` when the
  densest shard holds more than ``imbalance_ratio`` times the mean, and the
  host re-splits the mesh.

It lives here, not in the API layer, because `pic.distributed` needs it as
a `DistConfig` field and must not import the API.
"""

from __future__ import annotations

import dataclasses

__all__ = ["CommSpec"]


@dataclasses.dataclass(frozen=True)
class CommSpec:
    """Frozen and hashable: it is part of `DistConfig`, which keys the
    driver's window. ``imbalance_ratio`` is the halt threshold on
    ``max_shard_alive * n_shards / n_alive`` (1.0 is a perfect balance); it
    matters only with ``rebalance_enable``."""

    overlap_halo: bool = False
    compress_migration: bool = False
    rebalance_enable: bool = False
    imbalance_ratio: float = 4.0

    def __post_init__(self):
        if self.imbalance_ratio <= 1.0:
            raise ValueError(f"CommSpec.imbalance_ratio must exceed 1.0 (perfect balance), got {self.imbalance_ratio}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "CommSpec":
        names = {f.name for f in dataclasses.fields(CommSpec)}
        unknown = set(d) - names
        if unknown:
            raise ValueError(f"CommSpec has unknown keys {sorted(unknown)}")
        return CommSpec(**d)
