"""The port's kernel dispatcher: the registry, forced names and the
demotion ladder, the timed ``auto`` (memo, then the cache file, then a
benchmark), its cache file (keys, version, corruption, atomic merge), no
timing during a graph capture or a demotion, and the driver's prewarm at
set-up, after a growth and after a restore. The applicable cases of
tests/test_dispatch.py.

Timing runs here on keys whose platform a test names as a card, where the
kernels' backends are the ``auto`` candidates (on a CPU key ``auto`` is the
plain ``torch``, untimed); the thunks are plain Python or the kernels'
plain versions on CPU tensors. Every test gets its own cache file through
``REPRO_TORCH_AUTOTUNE_CACHE`` and a cold memo.
"""

import dataclasses
import json
import os
import time
import warnings

import pytest

torch = pytest.importorskip("torch")

import repro_torch.api as tapi  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.deposition import ops as dep_ops  # noqa: E402

CPU = torch.device("cpu")
KW = dict(device=CPU, order=1, grid_shape=(4, 4, 4), capacity=4)
CARD = "Test Card 80GB"


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setenv(dispatch.CACHE_ENV, str(tmp_path / "autotune.json"))
    dispatch.clear_memo()
    dispatch.reset_counters()
    yield
    dispatch.clear_memo()


@pytest.fixture
def timed_op(monkeypatch):
    """A registered op ``probe`` on a card's key: a slow ``cuda_reduced``
    and a fast ``cuda`` kernel backend, and a plain ``torch`` faster than
    both; plain Python on the CPU. The fast kernel's thunk bumps a kernel
    wrapper's launch count, as a kernel launch would."""
    def slow(_key, _device):
        return lambda: time.sleep(0.003)

    def fast(_key, _device):
        def run():
            dep_ops.LAUNCHES["fused_bin_deposit"] += 1
        return run

    def instant(_key, _device):
        return lambda: None

    monkeypatch.setattr(dispatch, "platform", lambda device: CARD)
    monkeypatch.setitem(dispatch._REGISTRY, "probe", {
        "torch": dispatch.Backend("torch", 10, lambda key: True, instant),
        "cuda": dispatch.Backend("cuda", 20, lambda key: True, fast, kernel=True),
        "cuda_reduced": dispatch.Backend("cuda_reduced", 30, lambda key: True, slow, kernel=True),
    })
    return "probe"


def _entries() -> dict:
    with open(dispatch.cache_path()) as f:
        return json.load(f)["entries"]


# -- registry and forced names -------------------------------------------------------


def test_registry_lists_expected_ops_and_backends():
    assert set(dispatch.ops()) >= {"deposit_fused", "gather_fused", "deposit_unfused", "bin_gather",
                                   "segment_accumulate"}
    assert set(dispatch.backends_for("deposit_fused")) == {"torch", "cuda", "cuda_reduced"}
    assert set(dispatch.backends_for("gather_fused")) == {"torch", "cuda"}


def test_register_requires_override_to_replace():
    existing = dispatch.backends_for("deposit_fused")["torch"]
    with pytest.raises(ValueError, match="already registered"):
        dispatch.register("deposit_fused", existing)
    dispatch.register("deposit_fused", dataclasses.replace(existing, priority=11), override=True)
    try:
        assert dispatch.backends_for("deposit_fused")["torch"].priority == 11
    finally:
        dispatch.register("deposit_fused", existing, override=True)


def test_unknown_op_and_backend_raise():
    with pytest.raises(KeyError, match="unknown op"):
        dispatch.backends_for("nope")
    with pytest.raises(ValueError, match="unknown backend"):
        dispatch.resolve("deposit_fused", "nope", **KW)


def test_forced_name_never_escalates():
    assert dispatch.resolve("deposit_fused", "torch", **KW) == "torch"
    assert dispatch.resolve("deposit_fused", "xla", **KW) == "torch"
    assert dispatch.resolve("gather_fused", "cuda_reduced", **KW) == "cuda"
    assert dispatch.resolve("deposit_fused", "cuda_reduced", **dict(KW, grid_shape=None, n_bins=64)) == "cuda"


def test_auto_on_the_cpu_is_torch_untimed():
    for op in ("deposit_fused", "gather_fused", "deposit_unfused", "bin_gather"):
        assert dispatch.resolve(op, "auto", **KW) == "torch"
    assert dispatch.resolve("segment_accumulate", "auto", device=CPU, capacity=2, n_bins=8, width=5) == "torch"
    assert dispatch.counters["benchmark"] == 0
    assert not os.path.exists(dispatch.cache_path())


# -- the timed auto and its cache --------------------------------------------------------


def test_auto_benchmarks_once_then_memo_then_cache(timed_op):
    launches = kernels.launch_counts()
    assert dispatch.resolve(timed_op, "auto", **KW) == "cuda"
    assert dispatch.counters["benchmark"] == 1
    assert kernels.launch_counts() == launches  # the timing's launches are taken back
    [(key, entry)] = _entries().items()
    assert key == f"probe|order1|grid4x4x4|cap4|bins64|float32|{CARD}"
    # the timing overrules the priority order; the plain version is no candidate
    assert entry["backend"] == "cuda" and entry["timings_us"]["cuda_reduced"] > entry["timings_us"]["cuda"] > 0
    assert set(entry["timings_us"]) == {"cuda", "cuda_reduced"} and entry["fill"] == 0
    assert dispatch.resolve(timed_op, "auto", **KW) == "cuda"
    assert dispatch.counters["memo_hit"] == 1
    dispatch.clear_memo()
    assert dispatch.resolve(timed_op, "auto", **KW) == "cuda"
    assert (dispatch.counters["benchmark"], dispatch.counters["cache_hit"]) == (1, 1)


def test_cache_key_distinguishes_shapes_not_occupancy(timed_op):
    """Every shape is its own key; the synthetic slab's occupancy is not:
    a choice made at one fill stands at another."""
    for kw in (KW, dict(KW, order=2), dict(KW, capacity=8), dict(KW, grid_shape=(4, 4, 8)), dict(KW, width=16),
               dict(KW, dtype=torch.bfloat16), dict(KW, fill=3)):
        dispatch.resolve(timed_op, "auto", **kw)
    assert dispatch.counters["benchmark"] == 6 and dispatch.counters["memo_hit"] == 1
    keys = list(_entries())
    assert len(keys) == 6
    assert sum("|width16" in k for k in keys) == 1 and sum("|bfloat16|" in k for k in keys) == 1


def test_platform_is_part_of_the_key(timed_op, monkeypatch):
    dispatch.resolve(timed_op, "auto", **KW)
    monkeypatch.setattr(dispatch, "platform", lambda device: "Other Card 40GB")
    dispatch.clear_memo()
    dispatch.resolve(timed_op, "auto", **KW)
    assert dispatch.counters["benchmark"] == 2
    assert sorted(k.rsplit("|", 1)[1] for k in _entries()) == ["Other Card 40GB", CARD]


def test_corrupt_cache_falls_back_loudly(timed_op):
    dispatch.resolve(timed_op, "auto", **KW)
    with open(dispatch.cache_path(), "w") as f:
        f.write("{this is not json")
    dispatch.clear_memo()
    with pytest.warns(RuntimeWarning, match="corrupt"):
        assert dispatch.resolve(timed_op, "auto", **KW) == "cuda"
    assert dispatch.counters["benchmark"] == 2
    dispatch.clear_memo()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        dispatch.resolve(timed_op, "auto", **KW)
    assert dispatch.counters["cache_hit"] == 1


def test_wrong_version_cache_is_rejected(timed_op):
    with open(dispatch.cache_path(), "w") as f:
        json.dump({"version": 999, "entries": {}}, f)
    with pytest.warns(RuntimeWarning, match="corrupt"):
        dispatch.resolve(timed_op, "auto", **KW)
    assert json.load(open(dispatch.cache_path()))["version"] == dispatch.CACHE_VERSION


def test_cache_merge_keeps_other_entries(timed_op):
    """Another process's entry, written after this one loaded the file,
    survives this one's write."""
    dispatch.resolve(timed_op, "auto", **KW)
    entries = _entries()
    entries["other|key"] = {"backend": "cuda", "timings_us": {"cuda": 1.0}}
    with open(dispatch.cache_path(), "w") as f:
        json.dump({"version": dispatch.CACHE_VERSION, "entries": entries}, f)
    dispatch.resolve(timed_op, "auto", **dict(KW, order=3))
    assert set(_entries()) == set(entries) | {f"probe|order3|grid4x4x4|cap4|bins64|float32|{CARD}"}


def test_auto_on_a_card_never_runs_the_plain_version(timed_op, monkeypatch):
    """``auto`` on a card picks among the kernels, whatever the cache says;
    only a forced ``torch`` (or a demotion to it) hands a card's tensors to
    the plain version, and each such resolution is counted."""
    with open(dispatch.cache_path(), "w") as f:
        json.dump({"version": dispatch.CACHE_VERSION, "entries": {
            f"probe|order1|grid4x4x4|cap4|bins64|float32|{CARD}": {"backend": "torch", "timings_us": {}}}}, f)
    assert dispatch.resolve(timed_op, "auto", **KW) == "cuda"
    assert dispatch.counters["benchmark"] == 1 and dispatch.counters["plain_on_card"] == 0
    for name in ("torch", "xla"):
        assert dispatch.resolve(timed_op, name, **KW) == "torch"
    assert dispatch.demote("cuda", **KW) == "torch"
    assert dispatch.counters["plain_on_card"] == 2
    # an op with no kernel has no answer for auto on a card
    monkeypatch.setitem(dispatch._REGISTRY, "plain_only", {"torch": dispatch.backends_for(timed_op)["torch"]})
    with pytest.raises(RuntimeError, match="no kernel backend"):
        dispatch.resolve("plain_only", "auto", **KW)


# -- no timing during a capture or a demotion -----------------------------------------


def test_auto_during_capture_never_benchmarks_or_persists(timed_op, monkeypatch):
    monkeypatch.setattr(dispatch, "_capturing", lambda: True)
    with pytest.warns(RuntimeWarning, match="CUDA graph capture"):
        assert dispatch.resolve(timed_op, "auto", **KW) == "cuda_reduced"  # priority order
    assert dispatch.counters["benchmark"] == 0 and dispatch.counters["trace_fallback"] == 1
    assert not os.path.exists(dispatch.cache_path())
    # nothing was kept: resolved eagerly, the key is timed for real
    monkeypatch.setattr(dispatch, "_capturing", lambda: False)
    dispatch.resolve(timed_op, "auto", **KW)
    assert dispatch.counters["benchmark"] == 1
    # and a capture after that finds the winner in the memo
    monkeypatch.setattr(dispatch, "_capturing", lambda: True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert dispatch.resolve(timed_op, "auto", **KW) == "cuda"


def test_demote_never_benchmarks(monkeypatch):
    """On a card's key left unmeasured, demoting ``auto`` answers from the
    priority order without timing or writing the cache."""
    monkeypatch.setattr(dispatch, "platform", lambda device: "Test Card 80GB")
    assert dispatch.demote("auto", **KW) == "cuda"
    assert dispatch.counters["benchmark"] == 0
    assert not os.path.exists(dispatch.cache_path())


def test_demote_walks_the_priority_ladder():
    assert dispatch.demote("cuda_reduced", **KW) == "cuda"
    assert dispatch.demote("pallas", **KW) == "torch"
    assert dispatch.demote("torch", **KW) is None
    assert dispatch.demote("auto", **KW) is None  # auto on the CPU is torch
    assert dispatch.counters["benchmark"] == 0


# -- the driver's prewarm ------------------------------------------------------------------


def test_simulation_prewarms_at_setup_after_growth_and_after_restore(monkeypatch, tmp_path):
    """On a key named as a card's, the driver times its one op with two
    kernel candidates (``deposit_fused``; the gather has one kernel, untimed)
    once at set-up, on a slab at the state's mean occupancy (the wrappers
    run their plain versions on CPU tensors), resolves from the memo while
    it runs, never to the plain version, times the new key after a capacity
    growth, and resolves the restored capacity's key after a restore."""
    monkeypatch.setattr(dispatch, "platform", lambda device: CARD)
    calls = []
    prewarm = dispatch.prewarm

    def spy(ops_, **kw):
        calls.append((tuple(ops_), kw["capacity"]))
        return prewarm(ops_, **kw)

    monkeypatch.setattr(dispatch, "prewarm", spy)
    torch.set_num_threads(1)
    sim = tapi.make_simulation(tapi.scenario("uniform", grid=(4, 4, 4), ppc=2, order=1, steps=2, window=2),
                               device="cpu")
    cap0 = sim.config.capacity
    assert sim.config.backend == "auto"
    assert calls == [(("deposit_fused", "gather_fused"), cap0)]
    assert dispatch.counters["benchmark"] == 1
    sim.run(2)
    assert dispatch.counters["benchmark"] == 1 and dispatch.counters["trace_fallback"] == 0
    assert dispatch.counters["plain_on_card"] == 0
    sim.save(str(tmp_path / "ck"))
    sim.config = dataclasses.replace(sim.config, capacity=1)
    sim._grow_capacity()
    assert calls[-1] == (("deposit_fused", "gather_fused"), sim.config.capacity) and sim.config.capacity != cap0
    assert dispatch.counters["benchmark"] == 2
    sim.run(2)
    sim.restore(str(tmp_path / "ck"))
    assert calls[-1] == (("deposit_fused", "gather_fused"), cap0) and sim.config.capacity == cap0
    assert dispatch.counters["benchmark"] == 2  # the restored key was measured at set-up
    entries = _entries()
    assert len(entries) == 2 and all(k.startswith("deposit_fused|") for k in entries)
    assert {e["fill"] for e in entries.values()} == {8}  # 2^3 particles a cell, all alive
    assert dispatch.counters["plain_on_card"] == 0
