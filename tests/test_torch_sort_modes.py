"""Port parity of the sort modes and the host-driven loop: the paper's
ablation axes ``rebuild`` (bins rebuilt every step), ``global`` (a global
sort every step) and ``none`` (the scatter baseline's, no bins) over 20
windowed steps against the reference, a forced capacity growth under
``rebuild``, and the host-driven per-step loop (``window=None``, a spec's
``run.window == 0``) against the reference's host loop and against the
port's own windowed run.

Both packages start from the same numpy-made particles and fields. The
reference runs its ``xla`` backend, the port its CPU route.

Tolerances, as tests/test_torch_sim.py: exact for bin slots, particle slots,
GPMA statistics, sort and rebuild counts, halts, growths and step counts;
over 20 steps fields rtol 2e-5 / atol 1e-6, particles rtol 2e-5 / atol 2e-5,
energies rtol 2e-5. The port's host loop against its own windowed run:
exact (the same operations in the same order on the CPU). The comparisons
with the host loop turn the performance trigger off: the host loop's is
wall-clock time, the window's a device proxy.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.api as tapi  # noqa: E402
from repro_torch.pic.simulation import PICConfig  # noqa: E402
from test_torch_sim import _assert_runs, _assert_states, _np_particles, _pair  # noqa: E402

NO_PERF = dict(sort_interval=7, min_sort_interval=3, sort_trigger_perf_enable=False)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize(
    "sort,extra",
    [("rebuild", {}), ("global", {}), ("none", dict(deposition="scatter", gather="scatter"))],
    ids=["rebuild", "global", "none-scatter"],
)
def test_sort_mode_windowed_20_steps(sort, extra):
    grid = (6, 6, 6)
    parts = _np_particles(grid, u_thermal=0.1, seed=20)
    sim_r, sim_t = _pair("uniform", grid=grid, order=2, sort=sort, particles=parts, **extra)
    assert sim_t.config.sort_mode == sim_r.config.sort_mode == sort
    sim_r.run(20, window=10, diagnostics_every=2)
    sim_t.run(20, window=10, diagnostics_every=2)
    assert sum(h["n_moved"] for h in sim_t.history) > 0 or sort == "none"
    _assert_runs(sim_r, sim_t)
    # these modes make no policy decision and leave the policy state alone
    assert sim_t.sorts == sim_t.rebuilds == 0
    for f in dataclasses.fields(sim_t.policy_state):
        np.testing.assert_array_equal(getattr(sim_t.policy_state, f.name).numpy(),
                                      np.asarray(getattr(sim_r.policy_state, f.name)), err_msg=f.name)
    assert int(sim_t.policy_state.steps_since_sort) == 0
    assert sim_t.host_reads == 2


def test_rebuild_capacity_growth():
    """A hot plasma in bins of capacity 8 under ``rebuild``: the step's own
    overflow halts the window, the host grows the capacity, the run
    resumes, identically in both packages."""
    grid = (6, 6, 6)
    parts = _np_particles(grid, u_thermal=0.4, seed=21)
    sim_r, sim_t = _pair("uniform", grid=grid, order=1, capacity=8, sort="rebuild", particles=parts)
    sim_r.run(20, window=10)
    sim_t.run(20, window=10)
    assert sim_t.growths["capacity"] >= 1 and sim_t.halts.get("bin_overflow", 0) >= 1
    assert sim_t.config.capacity > 8
    _assert_runs(sim_r, sim_t)


def _assert_equal_runs(a, b):
    """Two runs of the port, bit for bit."""
    assert (a.sorts, a.rebuilds, a.growths, a.config.capacity) == (b.sorts, b.rebuilds, b.growths, b.config.capacity)
    assert a.state.step == b.state.step
    for part in ("fields", "particles", "layout", "slab"):
        x, y = getattr(a.state, part), getattr(b.state, part)
        assert (x is None) == (y is None)
        if x is not None:
            for f in dataclasses.fields(x):
                assert torch.equal(getattr(x, f.name), getattr(y, f.name)), f"{part}.{f.name}"


@pytest.mark.parametrize(
    "name,window",
    [("uniform", 8), ("uniform", 50), ("lwfa", 10)],
    ids=["uniform-window-8", "uniform-window-50", "lwfa"],
)
def test_host_loop_matches_reference_and_window(name, window):
    """24 steps of the host-driven loop with the sort policy deciding on the
    host, against the reference's host loop and the port's windowed run
    (window 50 is one window cut short)."""
    if name == "uniform":
        grid = (6, 6, 6)
        parts = _np_particles(grid, u_thermal=0.1, seed=22)
        kw = dict(grid=grid, order=2)
    else:
        grid = (4, 4, 32)
        z_on = tapi.scenario("lwfa", grid=grid).plasma.profile.z_on
        parts = _np_particles(grid, u_thermal=0.01, seed=23, z_on=z_on)
        kw = dict(grid=grid)
    sim_r, sim_t = _pair(name, particles=parts, policy=NO_PERF, **kw)
    sim_r.run(24, window=None, diagnostics_every=4)
    sim_t.run(24, window=None, diagnostics_every=4)
    assert sim_t.sorts + sim_t.rebuilds >= 2, "the run never re-sorted: the test is vacuous"
    assert sim_t.windows == 0 and sim_t.graph_captures == 0
    assert sim_t.host_reads >= 3 * 24  # three statistics a step, the sorts' overflow, the diagnostics
    assert (sim_t.sorts, sim_t.rebuilds, sim_t.growths) == (sim_r.sorts, sim_r.rebuilds, sim_r.growths)
    assert [h["step"] for h in sim_t.history] == [h["step"] for h in sim_r.history]
    for ht, hr in zip(sim_t.history, sim_r.history):
        assert ht["n_alive"] == hr["n_alive"]
        np.testing.assert_allclose(ht["field_energy"], hr["field_energy"], rtol=2e-5)
        np.testing.assert_allclose(ht["kinetic_energy"], hr["kinetic_energy"], rtol=2e-5)
    _assert_states(sim_r, sim_t)
    assert dataclasses.asdict(sim_t.host_policy.state)["steps_since_sort"] == sim_r.policy.state.steps_since_sort

    _, wind = _pair(name, particles=parts, policy=NO_PERF, **kw)
    wind.run(24, window=window, diagnostics_every=4)
    _assert_equal_runs(sim_t, wind)
    assert [(h["step"], h["n_alive"], h["field_energy"], h["kinetic_energy"]) for h in sim_t.history] == [
        (h["step"], h["n_alive"], h["field_energy"], h["kinetic_energy"]) for h in wind.history]


def test_window_zero_in_a_spec_selects_the_host_loop():
    spec = tapi.scenario("uniform", grid=(4, 4, 4), steps=3, window=0)
    sim = tapi.make_simulation(spec, device="cpu")
    sim.run()
    assert sim.state.step == 3 and sim.windows == 0 and sim.host_reads >= 9
    sim.run(2, window=2)  # the same driver takes a window afterwards
    assert sim.state.step == 5 and sim.windows == 1


def test_unknown_sort_mode_is_refused_by_name():
    grid = tapi.GridSpec(shape=(4, 4, 4))
    for mode in ("incremental", "rebuild", "global", "none"):
        assert PICConfig(grid=grid, dt=0.1, sort_mode=mode).sort_mode == mode
    with pytest.raises(ValueError, match="'bucket'"):
        PICConfig(grid=grid, dt=0.1, sort_mode="bucket")
    with pytest.raises(ValueError, match="'bucket'"):
        tapi.scenario("uniform", sort="bucket")
