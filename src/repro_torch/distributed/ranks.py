"""The distributed PIC driver over several processes, one process a rank.

The one-process driver holds every shard of an ``(SX, SY)`` mesh on one
device, stacked on two leading shard axes (`repro_torch.pic.distributed`).
Over a `torch.distributed` process group each rank holds a contiguous
block of that stack instead: the ranks form a grid ``(PX, PY)`` with
``PX | SX`` and ``PY | SY``, and rank ``r = rx * PY + ry`` holds shards
``[rx * BX, (rx + 1) * BX) x [ry * BY, (ry + 1) * BY)``, ``BX = SX / PX``,
``BY = SY / PY``. With ``PX * PY = SX * SY`` a rank holds one shard, as a
device does under the reference's ``shard_map``.

`RankGrid` carries the grid and the group, and does the stack's collectives
across ranks:

* `RankGrid.ring_shift` is ``torch.roll`` along a shard axis (the
  reference's ``lax.ppermute`` over its ring), with the edge slab swapped
  with the neighbour rank on that axis by ``batch_isend_irecv``; along an
  axis of one rank it stays the local roll;
* `RankGrid.gather` is the full ``[SX, SY, ...]`` tensor of a per-shard
  value, by ``all_gather``: a reduction over the mesh is the stack's own
  ``.sum`` / ``.amax`` of it, so a float total is bit-equal to the
  one-process stack's (``all_reduce`` would add in another order).

Every rank reads the same reductions, so every rank takes the same branch
on the host. The payloads travel as their bytes (``uint8``), so that
neither backend has to know a dtype (gloo takes no ``uint16``).

The rank grid is always the x-first choice of `choose_rank_grid`, on a
re-split too. One process is ``ranks=None`` in the drivers, never a
`RankGrid` of one rank (`make_pic_mesh` returns no grid for a group of
one); a `RankGrid` always runs its collectives, so one built by hand over
a group of one runs the real ones.

`init_ranks` joins a group through a ``FileStore`` under a directory the
caller names (no network address): NCCL with ``cuda:rank`` on the card,
gloo on the CPU. `check_rank_request` refuses, by name, more ranks than
visible cards and a rank count with no grid that divides the mesh;
`check_rank_grid` refuses a given grid that does not divide it.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

__all__ = ["RankGrid", "check_rank_grid", "check_rank_request", "choose_rank_grid", "close_ranks", "init_ranks",
           "rank_device"]


def choose_rank_grid(world: int, sx: int, sy: int) -> tuple[int, int] | None:
    """The rank grid ``(px, py)`` of ``world`` ranks on an ``sx x sy``
    mesh, x first: the largest ``px`` dividing ``sx`` whose ``py = world /
    px`` divides ``sy``. None if there is none."""
    for px in range(min(world, sx), 0, -1):
        if world % px == 0 and sx % px == 0 and sy % (world // px) == 0:
            return px, world // px
    return None


def check_rank_grid(grid, sx: int, sy: int) -> tuple[int, int]:
    """``grid`` as ``(px, py)``, refused unless it divides the mesh."""
    px, py = (int(v) for v in grid)
    if px < 1 or py < 1 or sx % px or sy % py:
        raise ValueError(f"rank grid ({px}, {py}) does not divide the {sx}x{sy} mesh: each rank holds a "
                         f"contiguous block of shards, so px must divide {sx} and py must divide {sy}")
    return px, py


def check_rank_request(world: int, mesh_shape, *, n_cards: int | None = None) -> tuple[int, int]:
    """The x-first rank grid of ``world`` ranks on the mesh ``mesh_shape``,
    or an error naming the cause: more ranks than the ``n_cards`` visible
    cards (one card a rank; None on the CPU), or no grid that divides the
    mesh."""
    sx, sy = (int(v) for v in mesh_shape)
    if world < 1:
        raise ValueError(f"a run needs at least one rank, got {world}")
    if n_cards is not None and world > n_cards:
        raise RuntimeError(f"{world} ranks need {world} cards, one a rank, but {n_cards} are visible")
    found = choose_rank_grid(world, sx, sy)
    if found is None:
        raise ValueError(f"no rank grid of {world} ranks divides the {sx}x{sy} mesh: {world} must split as "
                         f"px * py with px dividing {sx} and py dividing {sy}")
    return found


def rank_device(rank: int, device=None) -> torch.device:
    """A rank's device: ``cuda:rank`` (one card a rank), or the CPU when
    ``device`` names it. The card must be visible."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if device is not None and torch.device(device).type != "cuda":
        raise ValueError(f"a rank runs on a card or on the CPU, not on {device}")
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if rank >= n_cards:
        raise RuntimeError(f"rank {rank} needs card cuda:{rank}, but {n_cards} are visible; pass device='cpu' to "
                           "run the ranks on the CPU")
    return torch.device("cuda", rank)


def init_ranks(rank: int, world: int, store_dir: str, *, device=None, timeout_s: float = 300.0) -> torch.device:
    """Join the process group of ``world`` processes as ``rank``, through a
    ``FileStore`` in ``store_dir`` (one directory a run, shared by its
    ranks): NCCL on ``cuda:rank``, gloo when ``device`` is the CPU.
    Returns the rank's device. A group that cannot form raises; nothing
    runs a smaller world in its place."""
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.FileStore(os.path.join(store_dir, "filestore"), world)
    kw = dict(device_id=dev) if dev.type == "cuda" else {}
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return dev


def close_ranks() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes, flat."""
    return t.reshape(-1).view(torch.uint8)


class RankGrid:
    """A rank grid ``(px, py)`` over a process group: this process's place
    in it (``rank``, the group's rank, row-major over the grid), the
    group's global ranks (``peers``) and the device the rank's tensors live
    on. Compared by identity: it keys captured windows with the
    `DistConfig` that carries it."""

    __slots__ = ("px", "py", "rank", "group", "peers", "device")

    def __init__(self, px: int, py: int, rank: int, group=None, *, peers=None, device=None):
        self.px, self.py, self.rank = int(px), int(py), int(rank)
        if not 0 <= self.rank < self.px * self.py:
            raise ValueError(f"rank {rank} is outside the ({px}, {py}) rank grid")
        self.group = group
        self.peers = tuple(range(self.px * self.py)) if peers is None else tuple(peers)
        self.device = torch.device("cpu") if device is None else torch.device(device)

    @staticmethod
    def of_group(sx: int, sy: int, group) -> "RankGrid":
        """The x-first rank grid of ``group`` on the ``sx x sy`` mesh, on
        the group's device: ``cuda:current`` for NCCL, else the CPU."""
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        px, py = check_rank_request(world, (sx, sy))
        peers = [dist.get_global_rank(group, i) for i in range(world)]
        nccl = dist.get_backend(group) == "nccl"
        device = torch.device("cuda", torch.cuda.current_device()) if nccl else torch.device("cpu")
        return RankGrid(px, py, rank, group, peers=peers, device=device)

    def regrid(self, px: int, py: int) -> "RankGrid":
        """The same group on another grid of as many ranks (a re-split)."""
        if px * py != self.world:
            raise ValueError(f"rank grid ({px}, {py}) holds {px * py} ranks, not the group's {self.world}")
        return RankGrid(px, py, self.rank, self.group, peers=self.peers, device=self.device)

    def __repr__(self) -> str:
        return f"RankGrid({self.px}, {self.py}, rank={self.rank})"

    @property
    def world(self) -> int:
        return self.px * self.py

    @property
    def coords(self) -> tuple[int, int]:
        return divmod(self.rank, self.py)

    def count(self, shard_axis: int) -> int:
        """Ranks along a shard axis (0: x, 1: y)."""
        return self.px if shard_axis == 0 else self.py

    def _peer(self, shard_axis: int, step: int) -> int:
        rx, ry = self.coords
        if shard_axis == 0:
            rx = (rx + step) % self.px
        else:
            ry = (ry + step) % self.py
        return self.peers[rx * self.py + ry]

    # -- the collectives ----------------------------------------------------------

    def ring_shift(self, t: torch.Tensor, shard_axis: int, shift: int) -> torch.Tensor:
        """``torch.roll(t, shift, shard_axis)`` over the whole mesh, ``t``
        this rank's block: with ``shift=+1`` shard j receives shard j - 1's
        slab, so the block's first row comes from the previous rank's last;
        ``-1`` the other way."""
        rolled = torch.roll(t, shifts=shift, dims=shard_axis)
        if self.count(shard_axis) == 1:
            return rolled
        if shift not in (1, -1):
            raise ValueError(f"a ring shift across ranks moves one shard, got shift {shift}")
        n = t.shape[shard_axis]
        take, put = (n - 1, 0) if shift > 0 else (0, n - 1)
        send = t.narrow(shard_axis, take, 1).contiguous()
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, _wire(send), self._peer(shard_axis, shift), self.group),
               dist.P2POp(dist.irecv, _wire(recv), self._peer(shard_axis, -shift), self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        rolled.narrow(shard_axis, put, 1).copy_(recv)
        return rolled

    def _all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (one shape on all ranks), stacked in rank
        order: ``[world, *t.shape]``."""
        t = t.contiguous()
        out = torch.empty((self.world,) + tuple(t.shape), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(_wire(out), _wire(t), group=self.group)
        return out

    def gather(self, per_shard: torch.Tensor, first: int = 0) -> torch.Tensor:
        """The full ``[SX, SY, ...]`` tensor of a per-shard value, given this
        rank's ``[BX, BY, ...]`` block (its shard axes at ``first`` and
        ``first + 1``)."""
        x = per_shard.movedim((first, first + 1), (0, 1))
        bx, by, rest = x.shape[0], x.shape[1], tuple(x.shape[2:])
        grid = self._all_gather(x).reshape((self.px, self.py, bx, by) + rest)
        full = grid.transpose(1, 2).reshape((self.px * bx, self.py * by) + rest)
        return full.movedim((0, 1), (first, first + 1))

    def block(self, full: torch.Tensor, first: int = 0) -> torch.Tensor:
        """This rank's block of a full ``[SX, SY, ...]`` tensor (shard axes
        at ``first`` and ``first + 1``), a view."""
        bx, by = full.shape[first] // self.px, full.shape[first + 1] // self.py
        rx, ry = self.coords
        return full.narrow(first, rx * bx, bx).narrow(first + 1, ry * by, by)

    def values(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's 0-d ``x`` as a ``[world]`` tensor, in rank order."""
        return self._all_gather(x.reshape(1)).reshape(self.world)

    def agree(self, value: int) -> int:
        """Rank 0's ``value`` on every rank: a host decision that could
        differ between ranks (a read of the wall clock, a timed choice)
        made once. One read on the host."""
        return int(self.values(torch.tensor(int(value), dtype=torch.int64, device=self.device))[0])

    def barrier(self) -> None:
        """Return once every rank is here. The host blocks on both
        backends (on NCCL a collective alone would only order the card's
        stream)."""
        if self.device.type == "cuda":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)
