"""The port's distributed driver in process: against its own single-device
driver, against the reference's on a 1x1 mesh, and through the facade,
the launcher, the spec, the chaos paths, the growths, the communication
options and the rebalance.

- 4x2 and 2x2 against the port's `Simulation` on the CPU at the
  reference's parity set-ups (tests/dist_sim_check.py: ``uniform`` 8^3 at
  orders 1-3, ``lwfa`` 8x8x32; 50 steps, window 10): ``n_alive`` exact, the
  final energies and every history row within 1e-4 of the total energy
  (lwfa 1e-3), its ``_assert_energy_parity``; the unfused modes at 2x2 the
  same;
- 1x1 against the reference's `DistSimulation` in this process (one JAX
  device), with both growths firing: slots, particle slots, ``alive``,
  weights, growths, halts, sorts and communication totals exact, floats
  rtol 2e-5; and a checkpoint moving both ways between the packages;
- the chaos paths of tests/dist_chaos_check.py (``uniform`` 8x8x16, 24
  steps, window 8, 4x2): sentinel on, ``nan_field``, ``recv_drop`` and a
  crash with autosave, each bit-equal to the clean run; growth
  (``dist_sim_check.py growth``: both hatches fire, 2e-2), overlap
  bit-equal and compressed migration charge-exact with 16 of 28 bytes a
  row (``dist_comm_check.py fast``), the forced-imbalance rebalance
  (``dist_comm_check.py rebalance``, 20 steps: nothing lost, charge exact,
  energies within 1e-3 of the run that does not re-split), and the
  host-driven loop bit-equal to the windowed one.
"""

import dataclasses
import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.api as rapi  # noqa: E402
import repro.core as rcore  # noqa: E402
import repro.pic as rpic  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
import repro_torch.pic as tpic  # noqa: E402
from repro_torch.core import SortPolicyConfig  # noqa: E402
from repro_torch.launch import pic_run  # noqa: E402
from repro_torch.pic import DistSimulation  # noqa: E402
from test_torch_sim import FIELDS, _np_particles  # noqa: E402

POLICY = dict(sort_interval=20, sort_trigger_perf_enable=False)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec(name="uniform", **ov):
    ov.setdefault("policy", SortPolicyConfig(**POLICY))
    return tapi.scenario(name, backend="torch", **ov)


def _run(spec, **kw):
    sim = tapi.make_simulation(spec, device="cpu", **kw)
    sim.run()
    return sim


def _assert_energy_parity(single, dist, tol):
    """tests/dist_sim_check.py's parity: live particles exact, the energies
    and every history row within ``tol`` of the total."""
    ds, dd = single.diagnostics(), dist.diagnostics()
    assert dd["n_alive"] == ds["n_alive"], (ds, dd)
    scale = abs(ds["total_energy"]) + 1e-12
    for key in ("field_energy", "kinetic_energy", "total_energy"):
        assert abs(ds[key] - dd[key]) / scale < tol, (key, ds[key], dd[key])
    assert [h["step"] for h in single.history] == [h["step"] for h in dist.history]
    for hs, hd in zip(single.history, dist.history):
        assert abs(hs["total_energy"] - hd["total_energy"]) / (abs(hs["total_energy"]) + 1e-12) < tol, hs["step"]


def _same_dist_state(a, b, n0=None):
    """Bit-equal fields and particles (the first ``n0`` rows a shard) and
    energy histories; padding rows beyond ``n0`` stay dead."""
    sa, sb = a.shard_state, b.shard_state
    assert torch.equal(sa.fields, sb.fields)
    n0 = n0 or sa.pos.shape[2]
    for k in ("pos", "u", "w", "alive"):
        assert torch.equal(getattr(sa, k)[:, :, :n0], getattr(sb, k)[:, :, :n0]), k
    assert not sa.alive[:, :, n0:].any() and not sb.alive[:, :, n0:].any()
    energies = lambda sim: [(h["step"], h["field_energy"], h["kinetic_energy"], h["n_alive"]) for h in sim.history]
    assert energies(a) == energies(b)


@pytest.mark.parametrize("case", ["uniform1-4x2", "uniform2-4x2", "uniform3-4x2", "uniform1-2x2", "lwfa-4x2",
                                  "unfused2-2x2"])
def test_dist_matches_single_device(case):
    name, mesh = case.split("-")
    kw = dict(steps=50, window=10, diagnostics_every=10, mesh=mesh)
    if name == "lwfa":
        spec = _spec("lwfa", grid=(8, 8, 32), order=1, dt=0.3, capacity=24, u_thermal=0.01, seed=0, mig_cap=512, **kw)
        tol = 1e-3
    else:
        order = int(name[-1])
        modes = dict(deposition="matrix_unfused", gather="matrix_unfused") if name.startswith("unfused") else {}
        spec = _spec(grid=(8, 8, 8), order=order, dt=0.2, capacity=16, u_thermal=0.05, mig_cap=512, **modes, **kw)
        tol = 1e-4
    dist = _run(spec)
    single = _run(dataclasses.replace(spec, mesh=tapi.MeshSpec()), particles=None)
    assert isinstance(dist, DistSimulation) and dist._host_step == 50
    assert dist.comm_stats["n_migrated"] > 0
    _assert_energy_parity(single, dist, tol)


# -- against the reference at 1x1, and checkpoints across the packages ------------------


def _pair_1x1(particles, **ov):
    spec_r = rapi.scenario("uniform", backend="xla", mesh=(1, 1), policy=rcore.SortPolicyConfig(**POLICY), **ov)
    spec_t = tapi.SimSpec.from_json(spec_r.to_json())
    fields = {n: np.zeros(spec_r.grid.shape, np.float32) for n in FIELDS}
    sim_r = rapi.make_simulation(spec_r, fields=rpic.FieldState(*(jnp.asarray(fields[n]) for n in FIELDS)),
                                 particles=rpic.ParticleState(**{k: jnp.asarray(v) for k, v in particles.items()}))
    sim_t = tapi.make_simulation(spec_t, fields=tpic.FieldState(*(torch.from_numpy(fields[n]) for n in FIELDS)),
                                 particles=tpic.ParticleState(**{k: torch.from_numpy(v.copy())
                                                                 for k, v in particles.items()}), device="cpu")
    return sim_r, sim_t


def _assert_matches_ref(sim_t, sim_r):
    assert (sim_t.sorts, sim_t.rebuilds, sim_t._host_step) == (sim_r.sorts, sim_r.rebuilds, sim_r._host_step)
    assert sim_t.growths == sim_r.growths and sim_t.halts == sim_r.halts
    assert sim_t.comm_stats == pytest.approx(sim_r.comm_stats, rel=1e-12)
    assert (sim_t.config.capacity, sim_t.config.mig_cap, sim_t.n_local) == \
        (sim_r.config.capacity, sim_r.config.mig_cap, sim_r.n_local)
    st, sr = sim_t.state, sim_r.state  # the reference's state dict, fields on the global grid
    assert sorted(st) == sorted(sr)
    for k in ("alive", "w", "slots", "pslot", "slab_valid"):
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(sr[k]), err_msg=k)
    for k in ("pos", "u"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(sr[k]), rtol=2e-5, atol=2e-5, err_msg=k)
    fg = sim_t.fields_global()
    for n, f, g in zip(FIELDS, sr["fields"], st["fields"]):
        np.testing.assert_allclose(getattr(fg, n).numpy(), np.asarray(f), rtol=2e-5, atol=1e-6, err_msg=n)
        assert torch.equal(g, getattr(fg, n))
    assert [h["n_moved"] for h in sim_t.history] == [h["n_moved"] for h in sim_r.history]


def test_1x1_matches_reference_and_checkpoints_cross(tmp_path):
    """Hot plasma, capacity 8 and mig_cap 4: both growths fire in both
    packages. Then each package continues from the other's checkpoint."""
    particles = _np_particles((8, 8, 8), u_thermal=0.3)
    ov = dict(grid=(8, 8, 8), order=2, steps=20, window=10, diagnostics_every=5, capacity=8, mig_cap=4)
    sim_r, sim_t = _pair_1x1(particles, **ov)
    sim_r.run()
    sim_t.run()
    assert sim_t.growths["capacity"] >= 1 and sim_t.growths["mig_cap"] >= 1, sim_t.growths
    _assert_matches_ref(sim_t, sim_r)

    # the reference's checkpoint continues in the port, the port's in the reference
    sim_r.save(str(tmp_path / "ref"))
    sim_t.save(str(tmp_path / "port"))
    with open(tmp_path / "port" / "checkpoint.json") as f:
        assert json.load(f)["driver"] == "dist"
    from_ref = tapi.load_simulation(str(tmp_path / "ref"), device="cpu")
    from_port = rapi.load_simulation(str(tmp_path / "port"))
    for sim in (from_ref, from_port, sim_r, sim_t):
        sim.run(6)
    _assert_matches_ref(from_ref, sim_r)
    _assert_matches_ref(sim_t, from_port)


# -- the facade, the launcher and the spec ------------------------------------------------


def test_facade_spec_and_refusals(tmp_path, monkeypatch):
    spec = tapi.scenario("uniform", mesh="2x2")
    assert spec.mesh.shape == (2, 2) and spec.to_json() == rapi.scenario("uniform", mesh="2x2").to_json()
    cfg = tapi.dist_config(tapi.scenario("uniform", grid=(8, 8, 16), mesh="4x2", mig_cap=64, overlap_halo=True))
    assert cfg.local_grid.shape == (2, 4, 16) and cfg.mig_cap == 64 and cfg.comm.overlap_halo
    with pytest.raises(ValueError, match="does not divide"):
        tapi.scenario("uniform", grid=(6, 8, 8), mesh="4x2")
    with pytest.raises(ValueError, match="bin-based"):
        tapi.scenario("uniform", mesh="2x2", deposition="scatter")
    with pytest.raises(ValueError, match="SXxSY"):
        tapi.MeshSpec("4by2")
    with pytest.raises(ValueError, match="single-device"):
        tapi.spec_signature(spec)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.make_simulation(spec)
    monkeypatch.undo()

    # a run on one mesh does not restore into another
    small = dict(grid=(8, 8, 8), steps=2, window=2)
    a = _run(_spec(mesh="2x2", **small))
    a.save(str(tmp_path / "a"))
    b = tapi.make_simulation(_spec(mesh="2x1", **small), device="cpu")
    with pytest.raises(ValueError, match="2x2 mesh but this driver runs 2x1"):
        b.restore(str(tmp_path / "a"))
    single = tapi.make_simulation(_spec(**small), device="cpu")
    with pytest.raises(ValueError, match="'dist' driver"):
        single.restore(str(tmp_path / "a"))


def test_pic_run_mesh_and_spec(tmp_path, capfd):
    buf = io.StringIO()
    with redirect_stdout(buf):
        pic_run.main(["--mesh", "2x2", "--device", "cpu", "--grid", "8", "8", "8", "--steps", "4", "--window", "2"])
    out = buf.getvalue()
    assert "mesh 2x2" in out and "host reads/window=1.0" in out and "comm_stats" in out, out
    path = tmp_path / "spec.json"
    with redirect_stdout(io.StringIO()):
        pic_run.main(["--mesh", "4x2", "--grid", "8", "8", "8", "--dump-spec", str(path)])
    assert tapi.SimSpec.from_json(path.read_text()).mesh.shape == (4, 2)
    buf = io.StringIO()
    with redirect_stdout(buf):
        pic_run.main(["--spec", str(path), "--device", "cpu", "--steps", "2", "--window", "2"])
    assert "mesh 4x2" in buf.getvalue()
    with pytest.raises(SystemExit):
        pic_run.main(["--mesh", "4x", "--device", "cpu"])

    # the reference's communication flags set spec.comm as its launcher does
    comm = ["--overlap-halo", "--compress-migration", "--rebalance", "--imbalance-ratio", "3.0"]
    with redirect_stdout(io.StringIO()):
        pic_run.main(["--mesh", "2x2", "--grid", "8", "8", "8", "--dump-spec", str(path), *comm])
    want = rapi.scenario("uniform", grid=(8, 8, 8), mesh="2x2", comm={"overlap_halo": True, "compress_migration": True,
                                                                       "rebalance_enable": True, "imbalance_ratio": 3.0})
    assert path.read_text() == want.to_json()
    # two ranks on the CPU (spawned processes: rank 0 prints to the inherited stdout)
    capfd.readouterr()
    pic_run.main(["--ranks", "2", "--device", "cpu", "--mesh", "2x2", "--grid", "8", "8", "8", "--steps", "4",
                  "--window", "2", *comm])
    out = capfd.readouterr().out
    assert out.count("mesh 2x2 over 2 ranks (2x1), device cpu") == 1, out
    assert "host reads/window=1.0" in out and "comm_stats" in out and "energies:" in out, out
    with pytest.raises(SystemExit):
        pic_run.main(["--ranks", "2", "--device", "cpu", "--grid", "8", "8", "8"])  # no mesh


# -- chaos paths (tests/dist_chaos_check.py) -------------------------------------------------


def _chaos(**ov):
    return tapi.make_simulation(_spec(grid=(8, 8, 16), steps=24, window=8, mesh="4x2", diagnostics_every=4,
                                      policy=SortPolicyConfig(), **ov), device="cpu")


def test_chaos_paths_bit_equal_to_clean_run(tmp_path):
    clean = _chaos()
    n0 = clean.n_local
    clean.run()

    sentinel = _chaos(health={"enable": True})
    sentinel.run()
    assert sentinel.halts == {} and sentinel.retries == 0
    _same_dist_state(clean, sentinel)
    for k in ("slots", "pslot", "slab_d", "slab_valid"):
        assert torch.equal(clean.state[k], sentinel.state[k]), k

    nan = _chaos(health={"enable": True}, fault={"kind": "nan_field", "step": 11, "component": "ez"})
    nan.run()
    assert nan.halts == {"nonfinite": 1} and nan.retries == 1 and nan.fault_injector.fired == 1
    _same_dist_state(clean, nan)

    recv = _chaos(health={"enable": True}, fault={"kind": "recv_drop", "step": 9})
    recv.run()
    assert recv.halts == {"mig_recv_dropped": 1} and recv.discarded_steps == 1
    assert recv.growths["n_local"] == 1 and recv.n_local == 2 * n0 and recv._host_step == 24
    _same_dist_state(clean, recv, n0)

    crash = _chaos(health={"enable": True}, fault={"kind": "crash", "step": 13})
    crash.run(autosave_every=8, autosave_path=str(tmp_path / "auto"))
    assert crash.restarts == 1 and crash._host_step == 24
    _same_dist_state(clean, crash)


def test_growth_hatches_fire_and_nothing_is_lost():
    """dist_sim_check.py growth: hot plasma, mig_cap 1, capacity 8."""
    kw = dict(grid=(8, 8, 8), order=1, dt=0.2, capacity=8, u_thermal=0.4, steps=50, window=10, diagnostics_every=10)
    dist = _run(_spec(mesh="4x2", mig_cap=1, **kw))
    single = _run(_spec(**kw))
    assert dist.growths["mig_cap"] > 0 and dist.growths["capacity"] > 0, dist.growths
    assert single.config.capacity > 8
    _assert_energy_parity(single, dist, tol=2e-2)


def test_overlap_bit_equal_and_compression_charge_exact():
    """dist_comm_check.py fast: 2x2, order 2, 20 steps."""
    kw = dict(grid=(8, 8, 8), order=2, dt=0.2, capacity=24, u_thermal=0.2, steps=20, window=10,
              diagnostics_every=10, mesh="2x2", mig_cap=512)
    base = _run(_spec(**kw))
    over = _run(_spec(overlap_halo=True, **kw))
    _same_dist_state(base, over)
    assert base.diagnostics() == over.diagnostics()
    comp = _run(_spec(compress_migration=True, **kw))
    charge = lambda s: float(torch.sum(s.state["w"].double() * s.state["alive"]))
    assert charge(comp) == charge(base)
    assert comp.diagnostics()["n_alive"] == base.diagnostics()["n_alive"]
    assert comp.comm_stats["n_migrated"] > 0
    assert comp.comm_stats["mig_payload_bytes"] * 28 == base.comm_stats["mig_payload_bytes"] * 16
    d0, d1 = base.diagnostics(), comp.diagnostics()
    assert abs(d0["total_energy"] - d1["total_energy"]) / abs(d0["total_energy"]) < 2e-2


def test_rebalance_resplits_without_loss():
    """dist_comm_check.py rebalance: every particle in the first x-shard of
    a 4x2 mesh of a 16x8x16 grid."""
    particles = _np_particles((16, 8, 16), u_thermal=0.05)
    keep = particles["pos"][:, 0] < 4.0
    particles = dict(particles, alive=particles["alive"] & keep)
    parts = tpic.ParticleState(**{k: torch.from_numpy(v.copy()) for k, v in particles.items()})
    kw = dict(grid=(16, 8, 16), order=1, dt=0.2, capacity=48, steps=20, window=10, diagnostics_every=10, mesh="4x2",
              mig_cap=512)
    ref = _run(_spec(**kw), particles=parts)
    reb = _run(_spec(rebalance_enable=True, imbalance_ratio=2.0, **kw), particles=parts)
    assert reb.growths["rebalance"] >= 1 and reb.mesh_shape != (4, 2), (reb.growths, reb.mesh_shape)
    assert reb.spec.mesh.shape == reb.mesh_shape
    n0, q0 = int(keep.sum()), float(np.sum(particles["w"][particles["alive"]].astype(np.float64)))
    charge = float(torch.sum(reb.state["w"].double() * reb.state["alive"]))
    assert reb.diagnostics()["n_alive"] == n0 and charge == q0 and reb._host_step == 20
    de, dr = ref.diagnostics(), reb.diagnostics()
    for key in ("field_energy", "kinetic_energy", "total_energy"):
        assert abs(de[key] - dr[key]) / abs(de["total_energy"]) < 1e-3, key
    assert reb.comm_stats["max_imbalance"] >= 2.0


def test_host_loop_bit_equal_to_windowed():
    """The host-driven loop (one read of the step's counters a step)
    against the windowed driver, the performance trigger off."""
    kw = dict(grid=(8, 8, 8), order=2, steps=12, diagnostics_every=4, mesh="2x2",
              policy=SortPolicyConfig(sort_interval=5, sort_trigger_perf_enable=False))
    host = _run(_spec(window=0, **kw))
    windowed = _run(_spec(window=6, **kw))
    assert host.sorts == windowed.sorts > 0
    assert host.host_reads > 12
    _same_dist_state(host, windowed)
    assert windowed.host_reads == windowed.windows
