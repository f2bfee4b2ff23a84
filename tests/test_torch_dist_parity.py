"""The port's distributed driver against the reference's on a 4x2 mesh.

One module-scoped fixture runs the reference's `DistSimulation` in one
subprocess with 8 forced host devices (this file's ``__main__``): the
``uniform`` plasma at orders 1-3 and ``lwfa`` (tests/dist_sim_check.py's
set-ups), 20 steps in windows of 10 under its ``POLICY``, every window's
fetched bundle recorded. The reference's particles (its ``PRNGKey(0)``
plasma) and fields come back as numpy arrays with its final states,
histories and counters, and the port runs the same inputs on the CPU.

The subprocess also moves a 2x2 run across the packages: the reference
saves a checkpoint at step 10 and runs 10 more steps, and continues for 10
steps from a checkpoint the port wrote at its own step 10; the port does
the same from the other side.

Tolerances: slots, particle slots, ``alive``, weights, slab validity, halt
codes and steps, growths, sort decisions and reasons, and every per-step
counter (``n_moved``, ``mig_send_overflow``, ``mig_recv_dropped``,
``n_unmigrated``, ``n_migrated``, ``mig_payload_bytes``,
``max_shard_alive``) exact; fields rtol 2e-5 / atol 1e-6, positions,
momenta and slab offsets rtol 2e-5 / atol 2e-5, energies rtol 2e-5, as
tests/test_sim_loop.py and ``dist_sim_check.py checkpoint`` hold them.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytestmark = pytest.mark.slow

STEPS, WINDOW, MESH = 20, 10, (4, 2)
POLICY = dict(sort_interval=20, sort_trigger_perf_enable=False)
FIELDS = ("ex", "ey", "ez", "bx", "by", "bz")
# (scenario, order, dt, capacity, global grid, local grid), as dist_sim_check.py
CASES = {
    "uniform1": ("uniform", 1, 0.2, 16, (8, 8, 8), (2, 4, 8)),
    "uniform2": ("uniform", 2, 0.2, 16, (8, 8, 8), (2, 4, 8)),
    "uniform3": ("uniform", 3, 0.2, 16, (8, 8, 8), (2, 4, 8)),
    "lwfa": ("lwfa", 1, 0.3, 24, (8, 8, 32), (2, 4, 32)),
}
EXACT_ROWS = ("active", "sorted", "reason", "n_moved", "n_alive", "mig_send_overflow", "mig_recv_dropped",
              "n_unmigrated", "n_migrated", "mig_payload_bytes", "max_shard_alive", "discarded")
STATE_KEYS = ("pos", "u", "w", "alive", "slots", "pslot", "slab_d", "slab_valid")
CKPT_SPEC = dict(grid=(8, 8, 8), u_thermal=0.05, mesh=(2, 2), steps=20, window=WINDOW, diagnostics_every=10)
REPO = Path(__file__).resolve().parents[1]


# -- the reference, in the subprocess -------------------------------------------------


def _ref_state(sim) -> dict:
    import jax

    st = jax.device_get(sim.state)
    out = {k: np.asarray(st[k]) for k in STATE_KEYS}
    out.update({f"fields.{n}": np.asarray(f) for n, f in zip(FIELDS, st["fields"])})
    return out


def _ref_scalars(sim) -> dict:
    return {"sorts": sim.sorts, "rebuilds": sim.rebuilds, "growths": dict(sim.growths), "halts": dict(sim.halts),
            "comm_stats": dict(sim.comm_stats), "capacity": sim.config.capacity, "mig_cap": sim.config.mig_cap,
            "n_local": sim.n_local, "host_step": sim._host_step, "history": sim.history}


def _reference_main(out_dir: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8 " + os.environ.get("XLA_FLAGS", "")
    import warnings

    import jax
    import jax.numpy as jnp

    import repro.pic.dist_simulation as dist_simulation
    from repro.api import load_simulation, make_simulation, scenario
    from repro.core import SortPolicyConfig
    from repro.pic import DistConfig, DistSimulation, FieldState, GridSpec, LaserSpec, inject_laser, \
        profiled_plasma, uniform_plasma

    warnings.simplefilter("ignore", DeprecationWarning)
    policy = SortPolicyConfig(**POLICY)
    arrays, meta = {}, {}
    bundles: list = []
    real_fetch = dist_simulation._fetch_bundle
    dist_simulation._fetch_bundle = lambda b: bundles.append(real_fetch(b)) or bundles[-1]
    for case, (name, order, dt, capacity, gshape, lshape) in CASES.items():
        grid = GridSpec(shape=gshape)
        if name == "uniform":
            parts = uniform_plasma(jax.random.PRNGKey(0), grid, ppc_each_dim=(2, 2, 2), density=1.0, u_thermal=0.05)
            fields = FieldState.zeros(grid.shape)
        else:
            parts = profiled_plasma(jax.random.PRNGKey(0), grid, ppc_each_dim=(2, 2, 2),
                                    density_fn=lambda z: jnp.where(z > 10.0, 1.0, 0.0), u_thermal=0.01)
            laser = LaserSpec(a0=1.5, wavelength=8.0, waist=4.0, duration=6.0, z_center=5.0)
            fields = inject_laser(FieldState.zeros(grid.shape), grid, laser)
        for k in ("pos", "u", "w", "alive"):
            arrays[f"{case}/in.{k}"] = np.asarray(getattr(parts, k))
        for n in FIELDS:
            arrays[f"{case}/in.fields.{n}"] = np.asarray(getattr(fields, n))
        cfg = DistConfig(local_grid=GridSpec(shape=lshape), dt=dt, order=order, capacity=capacity, mig_cap=512)
        sim = DistSimulation(fields, parts, cfg, mesh_shape=MESH, policy=policy)
        bundles.clear()
        sim.run(STEPS, window=WINDOW, diagnostics_every=10)
        arrays.update({f"{case}/{k}": v for k, v in _ref_state(sim).items()})
        windows = []
        for i, b in enumerate(bundles):
            for k in EXACT_ROWS + ("field_energy", "kinetic_energy"):
                arrays[f"{case}/w{i}.{k}"] = np.asarray(b["per_step"][k])
            windows.append({k: int(b[k]) for k in ("n_done", "n_sorts", "n_rebuilds", "halt_code", "halt_step",
                                                   "n_discarded")})
        meta[case] = dict(_ref_scalars(sim), windows=windows)

    spec = scenario("uniform", backend="xla", policy=policy, **CKPT_SPEC)
    sim = make_simulation(spec)
    sim.run(10)
    sim.save(os.path.join(out_dir, "ckpt_ref"))
    sim.run(10)
    arrays.update({f"ckpt_ref_cont/{k}": v for k, v in _ref_state(sim).items()})
    meta["ckpt_ref_cont"] = _ref_scalars(sim)
    sim = load_simulation(os.path.join(out_dir, "ckpt_port"))
    sim.run(10)
    arrays.update({f"ref_from_port/{k}": v for k, v in _ref_state(sim).items()})
    meta["ref_from_port"] = _ref_scalars(sim)
    np.savez(os.path.join(out_dir, "ref.npz"), **arrays)
    with open(os.path.join(out_dir, "ref.json"), "w") as f:
        json.dump(meta, f)


# -- the port -------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Run the port's 2x2 checkpoint half, then the reference in one
    subprocess; its arrays and scalars, and the port's continuation."""
    import torch

    from repro_torch.api import make_simulation, scenario
    from repro_torch.core import SortPolicyConfig

    out = tmp_path_factory.mktemp("dist_parity")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        port = make_simulation(scenario("uniform", backend="xla", policy=SortPolicyConfig(**POLICY), **CKPT_SPEC),
                               device="cpu")
        port.run(10)
        port.save(str(out / "ckpt_port"))
        port.run(10)
    finally:
        torch.set_num_threads(threads)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO / "src"), os.environ.get("PYTHONPATH", "")]),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out / "ref.npz") as data:
        arrays = {k: data[k] for k in data.files}
    with open(out / "ref.json") as f:
        meta = json.load(f)
    return {"dir": out, "arrays": arrays, "meta": meta, "port_cont": port}


@pytest.fixture(autouse=True)
def _one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_state(sim) -> dict:
    st = sim.state
    out = {k: st[k].numpy() for k in STATE_KEYS}
    out.update({f"fields.{n}": f.numpy() for n, f in zip(FIELDS, st["fields"])})
    return out


def _assert_state(port: dict, arrays: dict, prefix: str) -> None:
    for k in ("w", "alive", "slots", "pslot", "slab_valid"):
        np.testing.assert_array_equal(port[k], arrays[f"{prefix}/{k}"], err_msg=k)
    for k in ("pos", "u", "slab_d"):
        np.testing.assert_allclose(port[k], arrays[f"{prefix}/{k}"], rtol=2e-5, atol=2e-5, err_msg=k)
    for n in FIELDS:
        np.testing.assert_allclose(port[f"fields.{n}"], arrays[f"{prefix}/fields.{n}"], rtol=2e-5, atol=1e-6,
                                   err_msg=n)


def _assert_scalars(sim, meta: dict) -> None:
    assert (sim.sorts, sim.rebuilds, sim._host_step) == (meta["sorts"], meta["rebuilds"], meta["host_step"])
    assert sim.growths == meta["growths"] and sim.halts == meta["halts"]
    assert (sim.config.capacity, sim.config.mig_cap, sim.n_local) == (meta["capacity"], meta["mig_cap"],
                                                                       meta["n_local"])
    for key in ("n_migrated", "mig_payload_bytes"):
        assert sim.comm_stats[key] == meta["comm_stats"][key], key
    assert sim.comm_stats["max_imbalance"] == pytest.approx(meta["comm_stats"]["max_imbalance"], rel=1e-12)
    assert [h["step"] for h in sim.history] == [h["step"] for h in meta["history"]]
    for hp, hr in zip(sim.history, meta["history"]):
        assert (hp["n_alive"], hp["n_moved"]) == (hr["n_alive"], hr["n_moved"])
        for key in ("field_energy", "kinetic_energy", "total_energy"):
            assert hp[key] == pytest.approx(hr[key], rel=2e-5), (hp["step"], key)


@pytest.mark.parametrize("case", list(CASES))
def test_windowed_run_matches_reference(ref, case):
    import torch

    from repro_torch.core import SortPolicyConfig
    from repro_torch.pic import DistConfig, DistSimulation, FieldState, GridSpec, ParticleState

    name, order, dt, capacity, gshape, lshape = CASES[case]
    a = ref["arrays"]
    fields = FieldState(*(torch.from_numpy(a[f"{case}/in.fields.{n}"].copy()) for n in FIELDS))
    parts = ParticleState(**{k: torch.from_numpy(a[f"{case}/in.{k}"].copy()) for k in ("pos", "u", "w", "alive")})
    cfg = DistConfig(local_grid=GridSpec(shape=lshape), dt=dt, order=order, capacity=capacity, mig_cap=512,
                     backend="torch")
    sim = DistSimulation(fields, parts, cfg, mesh_shape=MESH, policy=SortPolicyConfig(**POLICY))
    bundles = []
    enter = sim._enter_window
    sim._enter_window = lambda *args: bundles.append(enter(*args)) or bundles[-1]
    sim.run(STEPS, window=WINDOW, diagnostics_every=10)

    meta = ref["meta"][case]
    assert len(bundles) == len(meta["windows"])
    for i, (b, want) in enumerate(zip(bundles, meta["windows"])):
        assert {k: b[k] for k in want} == want, i
        k = len(b["per_step"]["active"])
        for key in EXACT_ROWS:
            np.testing.assert_array_equal(b["per_step"][key], a[f"{case}/w{i}.{key}"][:k], err_msg=f"window {i} {key}")
        for key in ("field_energy", "kinetic_energy"):
            np.testing.assert_allclose(b["per_step"][key], a[f"{case}/w{i}.{key}"][:k], rtol=2e-5, err_msg=key)
    _assert_scalars(sim, meta)
    _assert_state(_port_state(sim), a, case)
    assert sum(int(np.sum(b["per_step"]["n_migrated"])) for b in bundles) > 0


def test_reference_checkpoint_continues_in_port(ref):
    """A 2x2 checkpoint the reference wrote at step 10, loaded and run 10
    steps by the port, against the reference's own 10 more steps."""
    from repro_torch.api import load_simulation
    from repro_torch.pic import DistSimulation

    sim = load_simulation(str(ref["dir"] / "ckpt_ref"), device="cpu")
    assert isinstance(sim, DistSimulation) and sim.mesh_shape == (2, 2)
    assert sim._host_step == 10
    sim.run(10)
    _assert_scalars(sim, ref["meta"]["ckpt_ref_cont"])
    _assert_state(_port_state(sim), ref["arrays"], "ckpt_ref_cont")


def test_port_checkpoint_continues_in_reference(ref):
    """A 2x2 checkpoint the port wrote at step 10, loaded and run 10 steps
    by the reference, against the port's own 10 more steps."""
    port = ref["port_cont"]
    _assert_scalars(port, ref["meta"]["ref_from_port"])
    _assert_state(_port_state(port), ref["arrays"], "ref_from_port")


if __name__ == "__main__":
    _reference_main(sys.argv[1])
