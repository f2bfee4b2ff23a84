"""Adaptive global re-sorting policy (paper §4.4, Table 4 parameters).

Counterpart of `repro.core.resort_policy`, both of its paths:

* ``policy_init`` / ``policy_update`` / ``policy_reset`` over a
  `SortPolicyState` of 0-d device tensors, evaluated inside the window
  step. The performance trigger uses the on-device proxy, an EMA of
  ``1 / (1 + moved_fraction)``.
* `ResortPolicy` over a `HostPolicyState`: the host-driven per-step loop
  (``Simulation.run(window=None)``), fed statistics already read on the
  host, with the paper's wall-clock performance trigger (particles/s EMA
  against the post-sort baseline).

The five prioritized strategies are evaluated in the reference's order:
minimum interval, fixed interval, rebuild count, empty-slot ratio, then the
performance proxy. Decisions and reason codes are the reference's exactly; with the
performance trigger off the two paths decide alike.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SortPolicyConfig:
    """Paper Table 4 thresholds."""

    sort_interval: int = 50
    min_sort_interval: int = 10
    sort_trigger_rebuild_count: int = 100
    sort_trigger_empty_ratio: float = 0.15
    sort_trigger_full_ratio: float = 0.85
    sort_trigger_perf_enable: bool = True
    sort_trigger_perf_degrad: float = 0.80


REASON_NONE = 0
REASON_OVERFLOW = 1
REASON_MIN_INTERVAL = 2
REASON_FIXED_INTERVAL = 3
REASON_REBUILD_COUNT = 4
REASON_EMPTY_LOW = 5
REASON_EMPTY_HIGH = 6
REASON_PERF = 7

REASON_NAMES = (
    "no_trigger",
    "overflow (mandatory rebuild)",
    "min_interval",
    "fixed_interval",
    "rebuild_count",
    "empty_ratio_low",
    "empty_ratio_high",
    "perf_degradation",
)

_EMA_DECAY = 0.8
_UNSET = -1.0      # sentinel for "no baseline/EMA seeded yet" (proxy is > 0)


@dataclasses.dataclass(frozen=True)
class SortPolicyState:
    """Policy counters (ShouldPerformGlobalSort state), 0-d device tensors."""

    steps_since_sort: torch.Tensor    # int32
    rebuilds_since_sort: torch.Tensor  # int32
    baseline_proxy: torch.Tensor      # float32, _UNSET until seeded post-sort
    proxy_ema: torch.Tensor           # float32, _UNSET until seeded post-sort


def policy_init(device=None) -> SortPolicyState:
    i = lambda: torch.zeros((), dtype=torch.int32, device=device)
    f = lambda: torch.full((), _UNSET, dtype=torch.float32, device=device)
    return SortPolicyState(steps_since_sort=i(), rebuilds_since_sort=i(), baseline_proxy=f(), proxy_ema=f())


def policy_reset(device=None) -> SortPolicyState:
    """ResetRankSortCounters: counters and both perf seeds clear together."""
    return policy_init(device)


def perf_proxy(n_moved: torch.Tensor, n_alive: torch.Tensor) -> torch.Tensor:
    """Device stand-in for particles/sec: 1 / (1 + moved_fraction)."""
    moved = n_moved.to(torch.float32)
    alive = torch.clamp_min(n_alive, 1).to(torch.float32)
    return 1.0 / (1.0 + moved / alive)


def policy_update(state: SortPolicyState, config: SortPolicyConfig, *, n_moved, n_alive, n_empty, n_slots: int):
    """record_step + should_sort in one evaluation.

    Returns ``(do_sort, reason_code, recorded_state)``: 0-d bool and int32
    tensors, and the state as if no sort happens (a caller that sorts swaps
    in ``policy_reset()`` instead)."""
    steps = state.steps_since_sort + 1
    rebuilds = state.rebuilds_since_sort

    proxy = perf_proxy(n_moved, n_alive)
    ema = torch.where(
        state.proxy_ema > 0.0,
        _EMA_DECAY * state.proxy_ema + (1.0 - _EMA_DECAY) * proxy,
        proxy,
    )
    baseline = torch.where(state.baseline_proxy > 0.0, state.baseline_proxy, proxy)
    # a device divisor: a Python-scalar divisor would become a multiply by
    # its reciprocal on the GPU, which can round differently
    slots_f = torch.full((), max(float(n_slots), 1.0), dtype=torch.float32, device=n_empty.device)
    empty_ratio = n_empty.to(torch.float32) / slots_f

    trig_fixed = steps >= config.sort_interval
    trig_rebuild = rebuilds >= config.sort_trigger_rebuild_count
    trig_lo = empty_ratio < config.sort_trigger_empty_ratio
    trig_hi = empty_ratio > config.sort_trigger_full_ratio
    trig_perf = (ema < config.sort_trigger_perf_degrad * baseline) & bool(config.sort_trigger_perf_enable)

    # first matching trigger, in the host path's priority order
    cascade = torch.where(
        trig_fixed, REASON_FIXED_INTERVAL,
        torch.where(
            trig_rebuild, REASON_REBUILD_COUNT,
            torch.where(
                trig_lo, REASON_EMPTY_LOW,
                torch.where(trig_hi, REASON_EMPTY_HIGH, torch.where(trig_perf, REASON_PERF, REASON_NONE)),
            ),
        ),
    ).to(torch.int32)

    gate = steps >= config.min_sort_interval  # strategy 1 blocks everything
    do_sort = gate & (cascade != REASON_NONE)
    reason = torch.where(gate, cascade, REASON_MIN_INTERVAL).to(torch.int32)

    recorded = SortPolicyState(
        steps_since_sort=steps.to(torch.int32),
        rebuilds_since_sort=rebuilds,
        baseline_proxy=baseline,
        proxy_ema=ema,
    )
    return do_sort, reason, recorded


# -- the host path: the per-step loop's policy (wall-clock perf trigger) ------


@dataclasses.dataclass
class HostPolicyState:
    steps_since_sort: int = 0
    rebuilds_since_sort: int = 0
    baseline_perf: float | None = None  # particles/s right after a sort
    perf_ema: float | None = None


class ResortPolicy:
    """ShouldPerformGlobalSort / ResetRankSortCounters (paper Alg. 1), on
    the host."""

    def __init__(self, config: SortPolicyConfig | None = None):
        self.config = config or SortPolicyConfig()
        self.state = HostPolicyState()

    def record_step(self, *, rebuilt: bool, perf: float | None = None) -> None:
        st = self.state
        st.steps_since_sort += 1
        if rebuilt:
            st.rebuilds_since_sort += 1
        if perf is not None:
            st.perf_ema = perf if st.perf_ema is None else _EMA_DECAY * st.perf_ema + (1.0 - _EMA_DECAY) * perf
            if st.baseline_perf is None:
                st.baseline_perf = perf

    def should_sort(self, *, empty_ratio: float, overflowed: bool = False) -> tuple[bool, str]:
        """Returns (do_sort, reason). Overflow forces a sort."""
        cfg, st = self.config, self.state
        if overflowed:
            return True, REASON_NAMES[REASON_OVERFLOW]
        if st.steps_since_sort < cfg.min_sort_interval:
            return False, REASON_NAMES[REASON_MIN_INTERVAL]
        if st.steps_since_sort >= cfg.sort_interval:
            return True, REASON_NAMES[REASON_FIXED_INTERVAL]
        if st.rebuilds_since_sort >= cfg.sort_trigger_rebuild_count:
            return True, REASON_NAMES[REASON_REBUILD_COUNT]
        if empty_ratio < cfg.sort_trigger_empty_ratio:
            return True, REASON_NAMES[REASON_EMPTY_LOW]
        if empty_ratio > cfg.sort_trigger_full_ratio:
            return True, REASON_NAMES[REASON_EMPTY_HIGH]
        if (
            cfg.sort_trigger_perf_enable
            and st.baseline_perf is not None
            and st.perf_ema is not None
            and st.perf_ema < cfg.sort_trigger_perf_degrad * st.baseline_perf
        ):
            return True, REASON_NAMES[REASON_PERF]
        return False, REASON_NAMES[REASON_NONE]

    def reset(self) -> None:
        """ResetRankSortCounters, right after a global sort: the counters
        and both performance seeds clear together."""
        self.state = HostPolicyState()
