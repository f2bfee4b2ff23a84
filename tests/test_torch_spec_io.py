"""Port parity of what a run shares with the reference across packages:
SimSpec JSON both ways for every registry scenario and backend name, the
fields the port refuses by name and the fault-tolerance fields it runs, the two_stream and weibel scenarios and
their analytic growth rates, checkpoints written by one package and
continued by the other, the launcher's ``--dump-spec`` and ``--spec``, and
the PM N-body example's step.

Tolerances: spec dicts and JSON text, growth rates, slots, counters and the
arrays a checkpoint carries are exact; continued runs are held as
tests/test_torch_sim.py holds windowed runs (fields rtol 2e-5 / atol 1e-6,
particles rtol 2e-5 / atol 2e-5, energies rtol 2e-5); the PM N-body step
over 5 steps: density and positions rtol 1e-5 / atol 1e-6 (float32 FFTs of
two libraries).
"""

import dataclasses
import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.api as rapi  # noqa: E402
import repro.core as rcore  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
from repro_torch.core import build_bins, cell_index  # noqa: E402
from repro_torch.kernels.dispatch import reference_name  # noqa: E402
from repro_torch.launch import pic_run  # noqa: E402
from test_torch_sim import FIELDS, _assert_runs, _assert_states, _np_particles, _pair  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
POLICY = dict(sort_interval=7, min_sort_interval=3)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_registries_name_the_same_scenarios():
    assert tapi.scenario_names() == rapi.scenario_names() == ["lwfa", "two_stream", "uniform", "weibel"]


@pytest.mark.parametrize("name", ["uniform", "lwfa", "two_stream", "weibel"])
def test_reference_spec_json_loads_in_the_port(name):
    """A spec that `repro` dumps loads in the port and dumps back to the same
    dict and the same text, under every backend name and sort mode."""
    for backend, sort in (("auto", "incremental"), ("xla", "rebuild"), ("pallas", "global"),
                          ("pallas_reduced", "none")):
        rspec = rapi.scenario(name, backend=backend, sort=sort, capacity=40, seed=3)
        tspec = tapi.SimSpec.from_json(rspec.to_json())
        assert tspec.to_dict() == rspec.to_dict()
        assert tspec.to_json() == rspec.to_json()
        assert tspec.deposition.backend == {"auto": "auto", "xla": "torch", "pallas": "cuda",
                                            "pallas_reduced": "cuda_reduced"}[backend]
        assert tapi.pic_config(tspec).sort_mode == sort
        assert tapi.SimSpec.from_json(tspec.to_json()) == tspec


@pytest.mark.parametrize("name", ["uniform", "lwfa", "two_stream", "weibel"])
def test_port_spec_json_loads_in_the_reference(name):
    for backend in ("auto", "torch", "cuda", "cuda_reduced"):
        tspec = tapi.scenario(name, backend=backend, order=2, window=0, diagnostics_every=3)
        rspec = rapi.SimSpec.from_json(tspec.to_json())
        assert rspec.to_dict() == tspec.to_dict()
        assert rspec.to_json() == tspec.to_json()
        assert rspec == rapi.scenario(name, backend=reference_name(backend), order=2, window=0, diagnostics_every=3)


@pytest.mark.parametrize(
    "override,field",
    [(dict(mesh="2x2"), "mesh.shape"), (dict(overlap_halo=True), "comm")],
    ids=["mesh", "comm"],
)
def test_unported_fields_are_refused_by_name(override, field):
    """A mesh and a communication option, which select and configure the
    distributed driver: each builds in the port as in the reference, and a
    reference spec that sets it loads with the same JSON and the same
    value of ``field``."""
    tspec = tapi.scenario("uniform", **override)
    rspec = rapi.scenario("uniform", **override)
    assert tspec.to_json() == rspec.to_json()
    assert tapi.SimSpec.from_json(rspec.to_json()) == tspec
    node, _, leaf = field.partition(".")
    got = tspec.to_dict()[node]
    assert got == rspec.to_dict()[node] != tapi.scenario("uniform").to_dict()[node]
    assert leaf == "" or got[leaf] == [2, 2]


@pytest.mark.parametrize(
    "override",
    [dict(health={"enable": True, "energy_rtol": 0.5, "max_retries": 2}),
     dict(health={"enable": True}, fault={"kind": "nan_field", "step": 3, "component": "by", "count": 2}),
     dict(autosave_every=5)],
    ids=["health", "fault", "autosave"],
)
def test_fault_tolerance_fields_load_and_run(override, tmp_path):
    """The sentinel, an injected fault and autosave: a reference spec that
    sets one loads in the port, its JSON round-trips exactly both ways, and
    it runs (the fault, armed for two firings, halts twice and is retried;
    autosave writes its step directories)."""
    if "autosave_every" in override:
        override = dict(override, autosave_path=str(tmp_path / "auto"))
    rspec = rapi.scenario("uniform", grid=(4, 4, 4), steps=6, window=3, **override)
    tspec = tapi.SimSpec.from_json(rspec.to_json())
    assert tspec.to_dict() == rspec.to_dict() and tspec.to_json() == rspec.to_json()
    assert rapi.SimSpec.from_json(tspec.to_json()) == rspec
    assert tapi.scenario("uniform", grid=(4, 4, 4), steps=6, window=3, **override) == tspec
    sim = tapi.make_simulation(tspec, device="cpu")
    sim.run()
    assert sim._host_step == 6
    if "fault" in override:
        assert sim.halts == {"nonfinite": 2} and sim.retries == 2 and sim.fault_injector.fired == 2
    if "autosave_every" in override:
        assert sorted(os.listdir(tmp_path / "auto")) == ["step_000000000", "step_000000006"]


def test_deprecated_use_pallas_is_normalised_away():
    with pytest.warns(DeprecationWarning):
        tspec = tapi.scenario("uniform", use_pallas=True)
    with pytest.warns(DeprecationWarning):
        rspec = rapi.scenario("uniform", use_pallas=True)
    assert tspec.deposition.backend == "cuda" and tspec.deposition.use_pallas is None
    assert tspec.to_dict() == rspec.to_dict()
    with pytest.raises(ValueError, match="unknown keys"):
        tapi.SimSpec.from_dict(dict(rspec.to_dict(), grids={}))


@pytest.mark.parametrize("name,rate", [("two_stream", "two_stream_growth_rate"), ("weibel", "weibel_growth_rate")])
def test_growth_rates_equal_the_reference(name, rate):
    for mode in range(1, 17):
        tspec = tapi.scenario(name)
        rspec = rapi.scenario(name)
        tspec = dataclasses.replace(tspec, plasma=dataclasses.replace(
            tspec.plasma, perturb=dataclasses.replace(tspec.plasma.perturb, mode=mode)))
        rspec = dataclasses.replace(rspec, plasma=dataclasses.replace(
            rspec.plasma, perturb=dataclasses.replace(rspec.plasma.perturb, mode=mode)))
        assert getattr(tapi, rate)(tspec) == getattr(rapi, rate)(rspec)
    assert getattr(tapi, rate)(tapi.scenario(name)) > 0.2


def _ref_particles(spec_r) -> dict:
    p = rapi.build_particles(spec_r)
    return {n: np.asarray(getattr(p, n)) for n in ("pos", "u", "w", "alive")}


def test_two_stream_20_steps():
    """The counter-streaming beams and their seeded mode, from the
    reference's own particles, 20 windowed steps with the diagnostics of
    every step."""
    spec_r = rapi.scenario("two_stream", backend="xla")
    sim_r, sim_t = _pair("two_stream", particles=_ref_particles(spec_r))
    sim_r.run(20, window=10)
    sim_t.run(20, window=10)
    assert len(sim_t.history) == 20
    _assert_runs(sim_r, sim_t)


def _saved_arrays(path) -> dict:
    meta = json.loads((Path(path) / "checkpoint.json").read_text())
    with np.load(Path(path) / "arrays.npz") as data:
        return meta, {n: data[f"a{i}"] for i, n in enumerate(meta["names"])}


def test_reference_checkpoint_continues_in_the_port(tmp_path):
    """The reference saves at step 10; the port loads the checkpoint (its
    spec and its arrays, exactly) and continues 10 steps as the reference
    does."""
    spec_r = rapi.scenario("uniform", grid=(6, 6, 6), order=2, backend="xla", u_thermal=0.1, window=5,
                           diagnostics_every=2, policy=rcore.SortPolicyConfig(**POLICY))
    sim_r = rapi.make_simulation(spec_r)
    sim_r.run(10)
    assert sim_r.sorts >= 1
    sim_r.save(str(tmp_path / "ref"))
    sim_t = tapi.load_simulation(str(tmp_path / "ref"), device="cpu")
    meta, arrays = _saved_arrays(tmp_path / "ref")
    assert sim_t.spec.to_dict() == meta["spec"]
    s = sim_t.state
    got = {"fields": s.fields, "particles": s.particles, "layout": s.layout, "slab": s.slab}
    for name, value in arrays.items():
        if name.startswith("['state']/.step"):
            assert s.step == int(value) == 10
            continue
        part, leaf = name.split("/")[-2:]
        obj = sim_t.policy_state if part == "['policy_state']" else got[part[1:]]
        np.testing.assert_array_equal(getattr(obj, leaf[1:]).numpy(), value, err_msg=name)
    assert (sim_t.sorts, sim_t.rebuilds, sim_t._host_step, sim_t.history) == (
        sim_r.sorts, sim_r.rebuilds, sim_r._host_step, sim_r.history)
    sim_r.run(10)
    sim_t.run(10)
    _assert_runs(sim_r, sim_t)


def test_port_checkpoint_continues_in_the_reference(tmp_path):
    grid = (6, 6, 6)
    sim_r, sim_t = _pair("uniform", grid=grid, order=2, window=5, diagnostics_every=2, policy=POLICY,
                         particles=_np_particles(grid, u_thermal=0.1, seed=30))
    sim_t.run(10)
    sim_r.run(10)
    assert sim_t.sorts >= 1
    sim_t.save(str(tmp_path / "port"))
    sim_r.save(str(tmp_path / "ref"))
    # the reference's format: the same metadata keys, leaves, dtypes and shapes
    (meta_t, arrays_t), (meta_r, arrays_r) = _saved_arrays(tmp_path / "port"), _saved_arrays(tmp_path / "ref")
    assert list(meta_t) == list(meta_r) and list(meta_t["scalars"]) == list(meta_r["scalars"])
    assert meta_t["names"] == meta_r["names"]
    assert {k: (a.dtype, a.shape) for k, a in arrays_t.items()} == {k: (a.dtype, a.shape) for k, a in arrays_r.items()}
    assert {k: v for k, v in meta_t["scalars"].items() if k != "history"} == {
        k: v for k, v in meta_r["scalars"].items() if k != "history"}
    loaded = rapi.load_simulation(str(tmp_path / "port"))
    assert loaded.config.backend == "xla" and loaded.spec.to_dict() == sim_t.spec.to_dict()
    assert (loaded.sorts, loaded._host_step, loaded.history) == (sim_t.sorts, 10, sim_t.history)
    _assert_states(loaded, sim_t, rtol_f=0, atol_f=0, rtol_p=0, atol_p=0)
    np.testing.assert_array_equal(np.asarray(loaded.state.slab.d), sim_t.state.slab.d.numpy())
    loaded.run(10)
    sim_t.run(10)
    _assert_runs(loaded, sim_t)
    # and back: the reference's checkpoint of the continued run in the port
    loaded.save(str(tmp_path / "back"))
    again = tapi.load_simulation(str(tmp_path / "back"), device="cpu")
    _assert_states(loaded, again, rtol_f=0, atol_f=0, rtol_p=0, atol_p=0)


def test_corrupt_or_foreign_checkpoints_are_refused(tmp_path):
    sim = tapi.make_simulation(tapi.scenario("uniform", grid=(4, 4, 4)), device="cpu")
    sim.run(2, window=2)
    path = tmp_path / "ck"
    sim.save(str(path))
    meta, arrays = _saved_arrays(path)
    # one changed value: its checksum no longer matches
    host = [arrays[n].copy() for n in meta["names"]]
    host[meta["names"].index("['state']/.particles/.u")][0, 0] += 1.0
    np.savez(path / "arrays.npz", **{f"a{i}": a for i, a in enumerate(host)})
    with pytest.raises(ValueError, match=r"checksum mismatch for \[\"\['state'\]/.particles/.u\"\]"):
        tapi.load_simulation(str(path), device="cpu")
    # a truncated file
    (path / "arrays.npz").write_bytes(b"PK\x03\x04")
    with pytest.raises(ValueError, match="corrupt or truncated"):
        sim.restore(str(path))
    # a checkpoint of another grid
    other = tapi.make_simulation(tapi.scenario("uniform", grid=(4, 4, 6)), device="cpu")
    other.save(str(tmp_path / "other"))
    with pytest.raises(ValueError, match="different grid"):
        sim.restore(str(tmp_path / "other"))
    # an overwrite is atomic: the old directory is replaced, nothing is left over
    sim.save(str(path))
    sim.restore(str(path))
    assert sorted(os.listdir(tmp_path)) == ["ck", "other"]


def test_pic_run_dump_spec_then_spec(tmp_path, capsys):
    path = tmp_path / "lwfa.json"
    pic_run.main(["--scenario", "lwfa", "--sort", "global", "--backend", "pallas", "--grid", "4", "4", "16",
                  "--dump-spec", str(path)])
    text = path.read_text()
    want = tapi.scenario("lwfa", sort="global", backend="cuda", grid=(4, 4, 16))
    assert tapi.SimSpec.from_json(text) == want
    assert rapi.SimSpec.from_json(text).to_dict() == want.to_dict()
    again = tmp_path / "again.json"
    pic_run.main(["--spec", str(path), "--dump-spec", str(again)])
    assert again.read_text() == text
    capsys.readouterr()
    pic_run.main(["--spec", str(path), "--device", "cpu", "--steps", "3", "--window", "0", "--backend", "torch"])
    out = capsys.readouterr().out
    assert "sort global" in out and "host-driven loop" in out and "host reads/step=" in out


def _load_example(name: str):
    spec = importlib.util.spec_from_file_location(f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_pm_nbody_step_matches_the_reference_example():
    """5 steps of the PM N-body example from the same numpy bodies: the
    reference example's step (its own `poisson_fft` and `gradient`, the
    reference's deposition, gather and GPMA update) against the port's
    `pm_step`."""
    ref_mod, port_mod = _load_example("pm_nbody"), _load_example("torch_pm_nbody")
    grid, dt, g = port_mod.GRID, port_mod.DT, rcore.max_guard(1)
    pos, vel, mass = port_mod.make_bodies(1024, grid, seed=1)
    cap = port_mod.initial_capacity(pos, grid)

    def ref_step(pos, vel, layout):
        rho = rcore.fold_guards(rcore.deposit_matrix(pos, mass_r, layout, grid_shape=grid.shape, order=1), g)
        rho = rho / grid.cell_volume
        phi = ref_mod.poisson_fft(rho - jnp.mean(rho), grid)
        acc = jnp.stack([rcore.gather_matrix(pos, rcore.unfold_guards(-ref_mod.gradient(phi, ax), g), layout,
                                             grid_shape=grid.shape, order=1) for ax in range(3)], axis=-1)
        vel2 = vel + dt * acc
        pos2 = jnp.mod(pos + dt * vel2, jnp.asarray(grid.shape, jnp.float32))
        layout2, stats = rcore.gpma_update(layout, rcore.cell_index(pos2, grid.shape), jnp.ones(pos.shape[0], bool))
        return pos2, vel2, layout2, stats, rho

    pr, vr, mass_r = jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(mass)
    lr, of = rcore.build_bins(rcore.cell_index(pr, grid.shape), jnp.ones(len(pos), bool), n_cells=grid.n_cells,
                              capacity=cap)
    pt, vt, mt = (torch.from_numpy(a.copy()) for a in (pos, vel, mass))
    lt, of_t = build_bins(cell_index(pt, grid.shape), torch.ones(len(pos), dtype=torch.bool), n_cells=grid.n_cells,
                          capacity=cap)
    assert int(of) == int(of_t) == 0
    np.testing.assert_array_equal(lt.slots.numpy(), np.asarray(lr.slots))
    moved = 0
    for _ in range(5):
        pr, vr, lr, sr, rho_r = ref_step(pr, vr, lr)
        pt, vt, lt, st, rho_t, _phi = port_mod.pm_step(pt, vt, lt, mt, grid=grid, dt=dt)
        np.testing.assert_allclose(rho_t.numpy(), np.asarray(rho_r), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(vt.numpy(), np.asarray(vr), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(pt.numpy(), np.asarray(pr), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(lt.slots.numpy(), np.asarray(lr.slots))
        np.testing.assert_array_equal(lt.particle_slot.numpy(), np.asarray(lr.particle_slot))
        for name in ("n_moved", "n_overflow", "n_empty", "n_alive"):
            assert int(getattr(st, name)) == int(getattr(sr, name)), name
        moved += int(st.n_moved)
    assert moved > 0
