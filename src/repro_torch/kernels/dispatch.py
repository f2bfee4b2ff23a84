"""Logical-op -> backend dispatch with a timed autotune. Counterpart of
`repro.kernels.dispatch`:

    op                  backends (priority)                         mode
    ------------------  ------------------------------------------  ------------------------
    deposit_fused       cuda_reduced (30) > cuda (20) > torch (10)  deposition="matrix"
    gather_fused        cuda (20) > torch (10)                      gather="matrix"
    deposit_unfused     cuda (20) > torch (10)                      deposition="matrix_unfused"
    bin_gather          cuda (20) > torch (10)                      gather="matrix_unfused"
    segment_accumulate  cuda (20) > torch (10)                      core.matrix_scatter_add

The backend names map one to one from the reference's: ``xla`` ->
``torch``, ``pallas`` -> ``cuda``, ``pallas_reduced`` -> ``cuda_reduced``
(`canonical` applies the map wherever a name is read, `reference_name`
the inverse wherever a spec is written).

A forced name resolves to itself, or to the best backend below it that the
op has at the key (``cuda_reduced`` on the gather runs ``cuda``); a ``cuda``
backend given a CPU tensor runs its kernel's plain PyTorch version (the
kernel wrappers in ``ops.py``). ``auto`` chooses among the kernels' backends
on a card and is ``torch`` on the CPU: the plain version is never an
``auto`` candidate on a card, nor a kernel on the CPU. Where a card has more
than one candidate (``deposit_fused``: ``cuda_reduced`` against ``cuda``),
``auto`` times each once at the call's exact shapes, on a synthetic slab
with ``fill`` occupied slots a bin (the driver passes its mean occupancy),
and keeps the fastest: each candidate's thunk runs the whole op as its
backend runs it (kernel #1 and the torch z pass on ``cuda``; #2 and its
y/x tail on ``cuda_reduced``).

A choice is looked up in the in-process memo, then in a JSON cache keyed
on (op, order, grid, capacity, bins, dtype, platform, width) at
``$REPRO_TORCH_AUTOTUNE_CACHE`` (default ``.repro_torch_autotune_cache.json``
in the working directory), and only then timed; the platform is the
card's name, so a cache from another card is not reused. ``counters``
counts timings, cache hits, memo hits, and ``plain_on_card``: resolutions
that hand a card's tensors to the plain version (a forced ``torch``, or the
supervisor's last demotion), which a caller that expects the kernels can
assert is 0.

Timing happens only when eager. Under a CUDA graph capture ``resolve``
answers in priority order and keeps nothing, so the drivers ``prewarm``
their keys before every capture (set-up, growth, restore, demotion) and the
captured step finds the timed winner in the memo.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import warnings
from typing import Any, Callable

import torch

DEFAULT_CACHE_FILE = ".repro_torch_autotune_cache.json"
CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
CACHE_VERSION = 1

#: the priority ladder: the order before any timing, and the order the
#: fault supervisor demotes along
BACKEND_PRIORITY = {"cuda_reduced": 30, "cuda": 20, "torch": 10}

#: reference backend name -> port backend name
REFERENCE_NAMES = {"xla": "torch", "pallas": "cuda", "pallas_reduced": "cuda_reduced"}

BENCH_ROUNDS = 5
BENCH_WARMUP = 1

#: "trace_fallback" counts ``auto`` resolutions that could not time because
#: a CUDA graph was being captured; "plain_on_card" counts resolutions that
#: run a card's tensors through the plain PyTorch version
counters = {"benchmark": 0, "cache_hit": 0, "memo_hit": 0, "trace_fallback": 0, "plain_on_card": 0}


def canonical(name: str) -> str:
    """A backend name in the port's vocabulary (reference names mapped)."""
    name = REFERENCE_NAMES.get(name, name)
    if name != "auto" and name not in BACKEND_PRIORITY:
        raise ValueError(
            f"unknown backend {name!r}; known: {sorted(BACKEND_PRIORITY)}, 'auto', "
            f"or a reference name {sorted(REFERENCE_NAMES)}"
        )
    return name


def reference_name(name: str) -> str:
    """A port backend name in the reference's vocabulary (``auto`` stays)."""
    name = canonical(name)
    return next((ref for ref, port in REFERENCE_NAMES.items() if port == name), name)


@dataclasses.dataclass(frozen=True)
class DispatchKey:
    """Everything a backend choice may depend on. ``platform`` is ``cpu``
    or the CUDA card's name; ``width`` is `segment_accumulate`'s feature
    width (0 for the PIC ops). ``fill`` is the occupied slots a bin of the
    synthetic slab a timing runs on (0: every slot); it is not part of the
    key: a choice made at one occupancy stands at another."""

    op: str
    order: int
    grid_shape: tuple[int, int, int] | None
    capacity: int
    n_bins: int
    dtype: str
    platform: str
    width: int = 0
    fill: int = dataclasses.field(default=0, compare=False)

    def cache_key(self) -> str:
        gs = "x".join(map(str, self.grid_shape)) if self.grid_shape else "none"
        wid = f"|width{self.width}" if self.width else ""
        return (f"{self.op}|order{self.order}|grid{gs}|cap{self.capacity}|bins{self.n_bins}|{self.dtype}"
                f"|{self.platform}{wid}")


@dataclasses.dataclass(frozen=True)
class Backend:
    """One implementation of a logical op. ``is_available(key)`` gates on
    the key's shapes; ``make_thunk(key, device)`` builds a nullary thunk
    that runs the op on synthetic inputs of the key's exact shapes (called
    only to time ``auto``). A ``kernel`` backend is a hand-written CUDA
    kernel: on a card only these are ``auto`` candidates, on the CPU only
    the others."""

    name: str
    priority: int
    is_available: Callable[[DispatchKey], bool]
    make_thunk: Callable[[DispatchKey, torch.device], Callable[[], Any]]
    kernel: bool = False


_REGISTRY: dict[str, dict[str, Backend]] = {}
# per (key, requested name): "auto" and a forced name may differ at one key
_MEMO: dict[tuple[DispatchKey, str], str] = {}


def register(op: str, backend: Backend, *, override: bool = False) -> None:
    """Register ``backend`` under ``op``; replacing a registered name needs
    ``override=True``."""
    table = _REGISTRY.setdefault(op, {})
    if backend.name in table and not override:
        raise ValueError(f"backend {backend.name!r} already registered for op {op!r} "
                         "(pass override=True to replace it)")
    table[backend.name] = backend
    _MEMO.clear()


def backends_for(op: str) -> dict[str, Backend]:
    _ensure_default_registry()
    if op not in _REGISTRY:
        raise KeyError(f"unknown op {op!r}; registered: {sorted(_REGISTRY)}")
    return dict(_REGISTRY[op])


def ops() -> tuple[str, ...]:
    _ensure_default_registry()
    return tuple(sorted(_REGISTRY))


def cache_path() -> str:
    return os.environ.get(CACHE_ENV) or DEFAULT_CACHE_FILE


def clear_memo() -> None:
    """Drop the in-process memo (the cache file stays): the next resolve of
    a key reads the file."""
    _MEMO.clear()


def reset_counters() -> None:
    for k in counters:
        counters[k] = 0


# -- resolution ----------------------------------------------------------------


def platform(device) -> str:
    """``cpu``, or the CUDA card's name."""
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def _capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph (timing there
    would record the thunks into the caller's graph)."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def make_key(op: str, *, device, order: int = 0, grid_shape=None, capacity: int = 0, n_bins: int | None = None,
             dtype="float32", width: int = 0, fill: int = 0) -> DispatchKey:
    if grid_shape is not None:
        grid_shape = tuple(int(s) for s in grid_shape)
        if n_bins is None:
            n_bins = grid_shape[0] * grid_shape[1] * grid_shape[2]
    return DispatchKey(op=op, order=int(order), grid_shape=grid_shape, capacity=int(capacity),
                       n_bins=int(n_bins or 0), dtype=str(dtype).removeprefix("torch."),
                       platform=platform(device), width=int(width), fill=int(fill))


def resolve(op: str, requested: str, *, device, order: int = 0, grid_shape=None, capacity: int = 0,
            n_bins: int | None = None, dtype="float32", width: int = 0, fill: int = 0,
            allow_benchmark: bool = True) -> str:
    """Resolve ``requested`` ("auto" or a backend name) to the backend that
    runs ``op`` at this key on tensors of ``device``.

    A forced name: the best available backend at or below it. ``auto``:
    the memo, then the cache file, then a timing of the candidates. With
    ``allow_benchmark=False`` (the supervisor's demotion, which must not run
    the kernels suspected of a halt) or under a graph capture, an
    unmeasured ``auto`` answers in priority order and keeps nothing."""
    key = make_key(op, device=device, order=order, grid_shape=grid_shape, capacity=capacity, n_bins=n_bins,
                   dtype=dtype, width=width, fill=fill)
    memo_key = (key, requested)
    if memo_key in _MEMO:
        counters["memo_hit"] += 1
        return _counted(key, _MEMO[memo_key])
    return _counted(key, _resolve(key, canonical(requested), memo_key, allow_benchmark, torch.device(device)))


def _counted(key: DispatchKey, name: str) -> str:
    if key.platform != "cpu" and not backends_for(key.op)[name].kernel:
        counters["plain_on_card"] += 1
    return name


def _resolve(key: DispatchKey, requested: str, memo_key, allow_benchmark: bool, device: torch.device) -> str:
    op = key.op
    table = backends_for(op)
    available = sorted((b for b in table.values() if b.is_available(key)), key=lambda b: -b.priority)
    if not available:
        raise RuntimeError(f"no available backend for op {op!r} at {key}")
    if requested != "auto":
        # never above the forced name (the demotion ladder depends on it)
        rank = BACKEND_PRIORITY[requested]
        choice = next((b for b in available if b.priority <= rank), available[-1]).name
        _MEMO[memo_key] = choice
        return choice

    on_card = key.platform != "cpu"
    candidates = [b for b in available if b.kernel == on_card]
    if not candidates:
        raise RuntimeError(f"no {'kernel' if on_card else 'plain'} backend for op {op!r} at {key}")
    if len(candidates) == 1:
        _MEMO[memo_key] = candidates[0].name
        return candidates[0].name

    path, ck = cache_path(), key.cache_key()
    cached = _load_cache(path).get(ck)
    if isinstance(cached, dict) and cached.get("backend") in {b.name for b in candidates}:
        counters["cache_hit"] += 1
        _MEMO[memo_key] = cached["backend"]
        return cached["backend"]

    if not allow_benchmark:
        return candidates[0].name
    if _capturing():
        counters["trace_fallback"] += 1
        warnings.warn(f"dispatch.resolve({op!r}, 'auto') called during a CUDA graph capture with no autotune "
                      f"entry for {ck}: running {candidates[0].name!r} (priority order) untimed. Resolve eagerly "
                      "first (dispatch.prewarm).", RuntimeWarning, stacklevel=2)
        return candidates[0].name

    name, timings = _benchmark(key, candidates, device)
    _merge_store(path, ck, {"backend": name, "timings_us": timings, "fill": key.fill})
    _MEMO[memo_key] = name
    return name


#: the dispatcher op a driver's deposition / gather mode runs (the scatter
#: and rhocell modes run none)
OP_BY_DEPOSITION = {"matrix": "deposit_fused", "matrix_unfused": "deposit_unfused"}
OP_BY_GATHER = {"matrix": "gather_fused", "matrix_unfused": "bin_gather"}


def ops_for_modes(deposition: str, gather: str) -> tuple[str, ...]:
    """The dispatcher ops a step with these modes resolves."""
    out = []
    if deposition in OP_BY_DEPOSITION:
        out.append(OP_BY_DEPOSITION[deposition])
    if gather in OP_BY_GATHER:
        out.append(OP_BY_GATHER[gather])
    return tuple(out)


def prewarm(ops_: tuple[str, ...] | list[str], *, device, order: int, grid_shape=None, capacity: int = 0,
            n_bins: int | None = None, dtype="float32", fill: int = 0, requested: str = "auto") -> dict[str, str]:
    """Resolve each op at one key eagerly (timing it if unmeasured, on a
    slab with ``fill`` occupied slots a bin): {op: backend}. The driver
    calls this before it captures a step."""
    return {op: resolve(op, requested, device=device, order=order, grid_shape=grid_shape, capacity=capacity,
                        n_bins=n_bins, dtype=dtype, fill=fill)
            for op in ops_}


def demote(current: str, *, device, order: int, grid_shape=None, capacity: int = 0, n_bins: int | None = None,
           dtype="float32") -> str | None:
    """The supervisor's last rung: the backend one step down the priority
    ladder from what ``current`` resolves to for ``deposit_fused`` (the op
    every matrix config runs), or None at the bottom. Never times: an
    unmeasured ``auto`` resolves from the memo or the cache, else in
    priority order, which is what an unmeasured captured step ran."""
    effective = resolve("deposit_fused", current, device=device, order=order, grid_shape=grid_shape,
                        capacity=capacity, n_bins=n_bins, dtype=dtype, allow_benchmark=False)
    ladder = sorted(BACKEND_PRIORITY, key=BACKEND_PRIORITY.get, reverse=True)
    below = [n for n in ladder if BACKEND_PRIORITY[n] < BACKEND_PRIORITY[effective]]
    return below[0] if below else None


# -- the cache file ----------------------------------------------------------------


def _load_cache(path: str, quiet: bool = False) -> dict:
    if not os.path.exists(path):
        return {}
    try:
        with open(path) as f:
            data = json.load(f)
        if data.get("version") != CACHE_VERSION or not isinstance(data.get("entries"), dict):
            raise ValueError(f"unexpected schema (want version {CACHE_VERSION})")
        return data["entries"]
    except (OSError, ValueError) as e:
        if not quiet:
            warnings.warn(f"autotune cache {path!r} is corrupt ({e}); ignoring it and re-benchmarking — the file "
                          "will be rewritten", RuntimeWarning, stacklevel=3)
        return {}


def _merge_store(path: str, ck: str, entry: dict) -> None:
    """Write one entry, re-reading the file just before the replace, so
    that processes updating different keys keep each other's entries."""
    entries = _load_cache(path, quiet=True)
    entries[ck] = entry
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump({"version": CACHE_VERSION, "entries": entries}, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError as e:  # a read-only directory: the choice stands, unpersisted
        warnings.warn(f"could not persist autotune cache to {path!r}: {e}", RuntimeWarning)
        if os.path.exists(tmp):
            os.remove(tmp)


def _time_us(fn: Callable[[], Any], device: torch.device) -> float:
    """One call's time: CUDA events on a CUDA device, the host clock
    elsewhere."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e3
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e6


def _benchmark(key: DispatchKey, candidates: list[Backend], device: torch.device) -> tuple[str, dict]:
    """Time each candidate's thunk: one warm-up call each, then
    `BENCH_ROUNDS` interleaved rounds; returns (winner, median microseconds
    per backend). The launches the thunks make are taken back out of the
    kernel wrappers' counts."""
    from repro_torch import kernels

    counters["benchmark"] += 1
    before = kernels.launch_counts()
    try:
        thunks = {b.name: b.make_thunk(key, device) for b in candidates}
        for fn in thunks.values():
            for _ in range(BENCH_WARMUP):
                fn()
        samples: dict[str, list[float]] = {n: [] for n in thunks}
        for _ in range(BENCH_ROUNDS):
            for name, fn in thunks.items():
                samples[name].append(_time_us(fn, device))
    finally:
        after = kernels.launch_counts()
        kernels.add_launches({n: after[n] - before.get(n, 0) for n in after}, -1)
    medians = {n: sorted(s)[len(s) // 2] for n, s in samples.items()}
    winner = min(medians, key=medians.get)
    return winner, {n: round(us, 1) for n, us in medians.items()}


# -- the default registry ----------------------------------------------------------


def _always(_key: DispatchKey) -> bool:
    return True


def _has_grid(key: DispatchKey) -> bool:
    # the reduced kernel walks whole z-columns: it needs the grid geometry
    return key.grid_shape is not None


def _randn(key: DispatchKey, device, seed: int, *shapes):
    """Normal synthetic operands of the key's type, from one seeded
    generator on the device."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=device).to(getattr(torch, key.dtype)) for shape in shapes]


def _synthetic_slab(key: DispatchKey, device):
    """(d, val), (n_bins, capacity, 3) each: offsets in [0, 0.999) and
    normal values in the first ``key.fill`` slots of every bin (all of them
    for 0), gap slots (0, 0) after them, as the driver's slab keeps them."""
    gen = torch.Generator(device=device).manual_seed(0)
    shape = (key.n_bins, key.capacity, 3)
    d = (torch.rand(shape, generator=gen, device=device) * 0.999).to(getattr(torch, key.dtype))
    val = _randn(key, device, 1, shape)[0]
    if 0 < key.fill < key.capacity:
        d[:, key.fill:] = 0
        val[:, key.fill:] = 0
    return d, val


def _deposit_fused_thunk(impl: str):
    def make(key: DispatchKey, device):
        from repro_torch.core.deposition import fused_deposit_grids

        d, val = _synthetic_slab(key, device)
        return lambda: fused_deposit_grids(d, val, grid_shape=key.grid_shape, order=key.order, backend=impl)

    return make


def _gather_fused_thunk(impl: str):
    def make(key: DispatchKey, device):
        from repro_torch.core.gather import fused_gather_bins
        from repro_torch.core.shape_functions import max_guard

        d, _ = _synthetic_slab(key, device)
        g = max_guard(key.order)
        [padded] = _randn(key, device, 2, (6, *(n + 2 * g for n in key.grid_shape)))
        return lambda: fused_gather_bins(d, padded, grid_shape=key.grid_shape, order=key.order, backend=impl)

    return make


def _taps(order: int) -> tuple[int, int]:
    """(M, N) of the unfused ops' synthetic operands: the staggered x
    support, the unstaggered y-z plane (the reference's thunks' shapes)."""
    from repro_torch.core.shape_functions import support

    m, _ = support(order, True)
    tu, _ = support(order, False)
    return m, tu * tu


def _deposit_unfused_thunk(impl: str):
    def make(key: DispatchKey, device):
        m, n = _taps(key.order)
        a, b = _randn(key, device, 3, (key.n_bins, key.capacity, m), (key.n_bins, key.capacity, n))
        if impl == "cuda":
            from repro_torch.kernels.deposition.ops import bin_outer_product

            return lambda: bin_outer_product(a, b)
        return lambda: torch.einsum("cpm,cpn->cmn", a, b)

    return make


def _bin_gather_thunk(impl: str):
    def make(key: DispatchKey, device):
        m, n = _taps(key.order)
        wx, byz, g = _randn(key, device, 4, (key.n_bins, key.capacity, m), (key.n_bins, key.capacity, n),
                            (key.n_bins, m, n))
        if impl == "cuda":
            from repro_torch.kernels.gather.ops import bin_gather

            return lambda: bin_gather(wx, byz, g)
        return lambda: torch.sum(wx * torch.einsum("cpn,cmn->cpm", byz, g), dim=-1)

    return make


def _segment_accumulate_thunk(impl: str):
    def make(key: DispatchKey, device):
        w, u = _randn(key, device, 5, (key.n_bins, key.capacity), (key.n_bins, key.capacity, key.width))
        if impl == "cuda":
            from repro_torch.kernels.scatter_matrix.ops import segment_accumulate as fn
        else:
            from repro_torch.kernels.scatter_matrix.ref import segment_accumulate_ref as fn
        return lambda: fn(w, u)

    return make


_DEFAULTS_REGISTERED = False


def _ensure_default_registry() -> None:
    global _DEFAULTS_REGISTERED
    if _DEFAULTS_REGISTERED:
        return
    _DEFAULTS_REGISTERED = True
    register("deposit_fused", Backend("torch", 10, _always, _deposit_fused_thunk("torch")))
    register("deposit_fused", Backend("cuda", 20, _always, _deposit_fused_thunk("cuda"), kernel=True))
    register("deposit_fused", Backend("cuda_reduced", 30, _has_grid, _deposit_fused_thunk("cuda_reduced"),
                                      kernel=True))
    register("gather_fused", Backend("torch", 10, _always, _gather_fused_thunk("torch")))
    register("gather_fused", Backend("cuda", 20, _always, _gather_fused_thunk("cuda"), kernel=True))
    register("deposit_unfused", Backend("torch", 10, _always, _deposit_unfused_thunk("torch")))
    register("deposit_unfused", Backend("cuda", 20, _always, _deposit_unfused_thunk("cuda"), kernel=True))
    register("bin_gather", Backend("torch", 10, _always, _bin_gather_thunk("torch")))
    register("bin_gather", Backend("cuda", 20, _always, _bin_gather_thunk("cuda"), kernel=True))
    register("segment_accumulate", Backend("torch", 10, _always, _segment_accumulate_thunk("torch")))
    register("segment_accumulate", Backend("cuda", 20, _always, _segment_accumulate_thunk("cuda"), kernel=True))
