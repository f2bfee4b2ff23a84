"""Port parity of the simulation: one step, 20-step windowed runs of the
``uniform`` and ``lwfa`` scenarios (with re-sorts and a forced capacity
growth) on the default path and in the comparison modes (``matrix_unfused``,
``scatter``, ``rhocell``), and `state_from_reference` with and without a
slab.

Both packages start from the same numpy-made particles and fields (their
random generators differ, so neither builds its own). The reference runs
its ``xla`` backend, the port its CPU route (the kernels' plain versions).

Tolerances:
- exact: bin slots, particle slots, GPMA stats, sort and rebuild counts,
  halts, capacity growths, step counts, weights and alive flags;
- one step: rtol 1e-5 / atol 1e-5 (one float32 step, summation order);
- 20 windowed steps: fields rtol 2e-5 / atol 1e-6, particles rtol 2e-5 /
  atol 2e-5, energies rtol 2e-5, as tests/test_sim_loop.py holds its two
  drivers (rounding differences compound over the steps).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.api as rapi  # noqa: E402
import repro.core as rcore  # noqa: E402
import repro.pic as rpic  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.pic as tpic  # noqa: E402
from repro.pic.simulation import pic_step as ref_pic_step  # noqa: E402
from repro_torch.pic.simulation import _pic_step  # noqa: E402

FIELDS = ("ex", "ey", "ez", "bx", "by", "bz")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_particles(grid, *, ppc=2, u_thermal=0.05, seed=0, z_on=None, scatter=False):
    """Lattice plasma with numpy thermal momenta; with ``z_on``, a vacuum
    below it (dead, zero-weight particles) as the lwfa profile makes; with
    ``scatter``, uniform random offsets in each cell instead of the lattice."""
    rng = np.random.default_rng(seed)
    off = (np.arange(ppc) + 0.5) / ppc
    cells = np.stack(np.meshgrid(*(np.arange(n) for n in grid), indexing="ij"), -1).reshape(-1, 1, 3)
    lattice = np.stack(np.meshgrid(off, off, off, indexing="ij"), -1).reshape(1, -1, 3)
    if scatter:
        lattice = rng.random((cells.shape[0], ppc**3, 3))
    pos = (cells + lattice).reshape(-1, 3).astype(np.float32)
    n = pos.shape[0]
    u = (u_thermal * rng.normal(size=(n, 3))).astype(np.float32)
    w = np.full(n, 1.0 / ppc**3, np.float32)
    if z_on is not None:
        w = np.where(pos[:, 2] > z_on, w, 0.0).astype(np.float32)
    return dict(pos=pos, u=u, w=w, alive=w > 0)


def _pair(name, *, particles, fields=None, policy=None, **overrides):
    """The same run in both packages: (reference Simulation, port Simulation).
    ``policy`` is a dict of `SortPolicyConfig` fields."""
    pol_r = {} if policy is None else {"policy": rcore.SortPolicyConfig(**policy)}
    pol_t = {} if policy is None else {"policy": tcore.SortPolicyConfig(**policy)}
    spec_r = rapi.scenario(name, backend="xla", **overrides, **pol_r)
    spec_t = tapi.scenario(name, backend="torch", **overrides, **pol_t)
    if fields is None:
        fields = {n: np.asarray(getattr(rapi.build_fields(spec_r), n)) for n in FIELDS}
    sim_r = rapi.make_simulation(
        spec_r,
        fields=rpic.FieldState(*(jnp.asarray(fields[n]) for n in FIELDS)),
        particles=rpic.ParticleState(**{k: jnp.asarray(v) for k, v in particles.items()}),
    )
    sim_t = tapi.make_simulation(
        spec_t,
        fields=tpic.FieldState(*(torch.from_numpy(fields[n].copy()) for n in FIELDS)),
        particles=tpic.ParticleState(**{k: torch.from_numpy(v.copy()) for k, v in particles.items()}),
        device="cpu",
    )
    return sim_r, sim_t


def _ref_arrays(sim) -> dict:
    s, ps = sim.state, sim.policy_state
    out = {f"fields.{n}": np.asarray(getattr(s.fields, n)) for n in FIELDS}
    out.update({f"particles.{n}": np.asarray(getattr(s.particles, n)) for n in ("pos", "u", "w", "alive")})
    out.update({"layout.slots": np.asarray(s.layout.slots), "layout.particle_slot": np.asarray(s.layout.particle_slot),
                "step": int(s.step)})
    if s.slab is not None:
        out.update({"slab.d": np.asarray(s.slab.d), "slab.valid": np.asarray(s.slab.valid)})
    out.update({f"policy.{f.name}": np.asarray(getattr(ps, f.name)) for f in dataclasses.fields(ps)})
    return out


def _assert_states(sim_r, sim_t, *, rtol_f=2e-5, atol_f=1e-6, rtol_p=2e-5, atol_p=2e-5):
    sr, st = sim_r.state, sim_t.state
    assert int(sr.step) == st.step
    assert sim_r.config.capacity == sim_t.config.capacity
    np.testing.assert_array_equal(st.layout.slots.numpy(), np.asarray(sr.layout.slots))
    np.testing.assert_array_equal(st.layout.particle_slot.numpy(), np.asarray(sr.layout.particle_slot))
    for n in ("w", "alive"):
        np.testing.assert_array_equal(getattr(st.particles, n).numpy(), np.asarray(getattr(sr.particles, n)))
    for n in ("pos", "u"):
        np.testing.assert_allclose(getattr(st.particles, n).numpy(), np.asarray(getattr(sr.particles, n)),
                                   rtol=rtol_p, atol=atol_p, err_msg=n)
    for n in FIELDS:
        np.testing.assert_allclose(getattr(st.fields, n).numpy(), np.asarray(getattr(sr.fields, n)),
                                   rtol=rtol_f, atol=atol_f, err_msg=n)


def _assert_runs(sim_r, sim_t):
    assert (sim_t.sorts, sim_t.rebuilds) == (sim_r.sorts, sim_r.rebuilds)
    assert sim_t.halts == sim_r.halts
    assert sim_t.growths == sim_r.growths
    assert [h["step"] for h in sim_t.history] == [h["step"] for h in sim_r.history]
    for ht, hr in zip(sim_t.history, sim_r.history):
        assert (ht["n_alive"], ht["n_moved"]) == (hr["n_alive"], hr["n_moved"])
        np.testing.assert_allclose(ht["field_energy"], hr["field_energy"], rtol=2e-5)
        np.testing.assert_allclose(ht["kinetic_energy"], hr["kinetic_energy"], rtol=2e-5)
    _assert_states(sim_r, sim_t)


@pytest.mark.parametrize("order", [1, 3])
def test_one_step_exact_structure(order):
    grid = (6, 6, 6)
    sim_r, sim_t = _pair("uniform", grid=grid, order=order, particles=_np_particles(grid, u_thermal=0.3, scatter=True))
    _assert_states(sim_r, sim_t, rtol_f=0, atol_f=0, rtol_p=0, atol_p=0)  # init: a pure sort
    state_r, stats_r = ref_pic_step(sim_r.state, sim_r.config)
    state_t, stats_t = _pic_step(sim_t.state, sim_t.config)
    for name in ("n_moved", "n_overflow", "n_empty", "n_alive"):
        assert int(getattr(stats_t, name)) == int(getattr(stats_r, name)), name
    assert int(stats_t.n_moved) > 0
    sim_r.state, sim_t.state = state_r, state_t
    _assert_states(sim_r, sim_t, rtol_f=1e-5, atol_f=1e-5, rtol_p=1e-5, atol_p=1e-5)
    np.testing.assert_array_equal(state_t.slab.valid.numpy(), np.asarray(state_r.slab.valid))


def test_windowed_uniform_20_steps():
    grid = (8, 8, 8)
    parts = _np_particles(grid, u_thermal=0.05, seed=1)
    sim_r, sim_t = _pair("uniform", grid=grid, order=2, particles=parts,
                         policy=dict(sort_interval=7, min_sort_interval=3))
    sim_r.run(20, window=10, diagnostics_every=5)
    sim_t.run(20, window=10, diagnostics_every=5)
    assert sim_t.sorts >= 2, "the run never re-sorted: the test is vacuous"
    _assert_runs(sim_r, sim_t)
    # the decisions are tested where the state lives (on the CPU here): one
    # bundle read per window
    assert sim_t.host_reads == 2


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("mode", ["matrix_unfused", "scatter"])
def test_windowed_comparison_modes_20_steps(mode, order):
    """The same deposition and gather mode in both packages: the six-call
    matrix gather and per-component matrix deposition, or the per-particle
    scatter baseline. Neither mode carries a slab."""
    grid = (8, 8, 8)
    parts = _np_particles(grid, u_thermal=0.05, seed=10 + order)
    sim_r, sim_t = _pair("uniform", grid=grid, order=order, deposition=mode, gather=mode, particles=parts,
                         policy=dict(sort_interval=7, min_sort_interval=3))
    assert sim_t.state.slab is None and sim_r.state.slab is None
    sim_r.run(20, window=10, diagnostics_every=5)
    sim_t.run(20, window=10, diagnostics_every=5)
    assert sim_t.sorts >= 2, "the run never re-sorted: the test is vacuous"
    _assert_runs(sim_r, sim_t)
    assert sim_t.host_reads == 2


def test_windowed_lwfa_rhocell_20_steps():
    grid = (4, 4, 32)
    spec = tapi.scenario("lwfa", grid=grid)
    parts = _np_particles(grid, u_thermal=0.01, seed=5, z_on=spec.plasma.profile.z_on)
    sim_r, sim_t = _pair("lwfa", grid=grid, deposition="rhocell", gather="scatter", particles=parts)
    assert (sim_t.config.deposition, sim_t.config.gather) == ("rhocell", "scatter")
    assert not sim_t.config.needs_bins
    sim_r.run(20, window=10, diagnostics_every=4)
    sim_t.run(20, window=10, diagnostics_every=4)
    assert sim_t.sorts > 0
    _assert_runs(sim_r, sim_t)


def test_windowed_lwfa_20_steps():
    grid = (4, 4, 32)
    spec = tapi.scenario("lwfa", grid=grid)
    parts = _np_particles(grid, u_thermal=0.01, seed=2, z_on=spec.plasma.profile.z_on)
    assert not parts["alive"].all()
    sim_r, sim_t = _pair("lwfa", grid=grid, particles=parts)
    assert sim_t.config.capacity == 48
    sim_r.run(20, window=10, diagnostics_every=4)
    sim_t.run(20, window=10, diagnostics_every=4)
    assert sim_t.sorts + sim_t.rebuilds > 0
    _assert_runs(sim_r, sim_t)


def test_windowed_capacity_growth():
    """A hot plasma in bins of capacity 8: the window halts on a persistent
    overflow, the host grows the capacity and the run resumes — identically."""
    grid = (6, 6, 6)
    parts = _np_particles(grid, u_thermal=0.4, seed=3)
    sim_r, sim_t = _pair("uniform", grid=grid, order=1, capacity=8, particles=parts)
    sim_r.run(20, window=10)
    sim_t.run(20, window=10)
    assert sim_t.growths["capacity"] >= 1 and sim_t.halts.get("bin_overflow", 0) >= 1
    assert sim_t.config.capacity > 8
    _assert_runs(sim_r, sim_t)


def test_state_from_reference_then_continue():
    grid = (6, 6, 6)
    parts = _np_particles(grid, u_thermal=0.1, seed=4)
    sim_r, sim_t = _pair("uniform", grid=grid, order=2, particles=parts)
    sim_r.run(6, window=6)
    arrays = _ref_arrays(sim_r)
    state, pstate = tpic.state_from_reference(arrays, sim_t.config, "cpu")
    for key, value in arrays.items():
        section, _, name = key.partition(".")
        got = {"fields": lambda: getattr(state.fields, name), "particles": lambda: getattr(state.particles, name),
               "layout": lambda: getattr(state.layout, name), "slab": lambda: getattr(state.slab, name),
               "policy": lambda: getattr(pstate, name), "step": lambda: state.step}[section]()
        np.testing.assert_array_equal(np.asarray(got), value, err_msg=key)
    rebuilt, _ = tpic.state_from_reference({k: v for k, v in arrays.items() if not k.startswith("slab")},
                                           sim_t.config, "cpu")
    np.testing.assert_array_equal(rebuilt.slab.d.numpy(), arrays["slab.d"])
    sim_t.state, sim_t.policy_state, sim_t._host_step = state, pstate, 6
    sim_r.run(6, window=6)
    sim_t.run(6, window=6)
    _assert_states(sim_r, sim_t)
    # the host-facing global sort, from the same state
    sorted_r, of_r = rpic.global_sort(sim_r.state, sim_r.config)
    sorted_t, of_t = tpic.global_sort(sim_t.state, sim_t.config)
    assert of_t == of_r == 0
    np.testing.assert_array_equal(sorted_t.layout.slots.numpy(), np.asarray(sorted_r.layout.slots))
    np.testing.assert_array_equal(sorted_t.particles.w.numpy(), np.asarray(sorted_r.particles.w))


def test_state_from_reference_without_a_slab():
    """A scatter-mode reference state carries no slab: the port takes it as
    it is, and a fused-mode config rebuilds the slab it needs."""
    grid = (6, 6, 6)
    parts = _np_particles(grid, u_thermal=0.1, seed=6)
    sim_r, sim_t = _pair("uniform", grid=grid, order=2, deposition="scatter", gather="scatter", particles=parts)
    sim_r.run(4, window=4)
    assert sim_r.state.slab is None
    arrays = {k: v for k, v in _ref_arrays(sim_r).items() if not k.startswith("slab")}
    state, pstate = tpic.state_from_reference(arrays, sim_t.config, "cpu")
    assert state.slab is None
    fused = tpic.state_from_reference(arrays, dataclasses.replace(sim_t.config, deposition="matrix", gather="matrix"),
                                      "cpu")[0]
    np.testing.assert_array_equal(fused.slab.valid.numpy(), arrays["layout.slots"] >= 0)
    sim_t.state, sim_t.policy_state, sim_t._host_step = state, pstate, 4
    sim_r.run(4, window=4)
    sim_t.run(4, window=4)
    _assert_states(sim_r, sim_t)
