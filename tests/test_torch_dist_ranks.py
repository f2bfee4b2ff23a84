"""The port's distributed driver over ranks, one process a rank (gloo on the
CPU), against the one-process stack and against the reference.

One module-scoped fixture writes the inputs (tests/dist_ranks_check.py
``make_inputs``), starts the reference's `DistSimulation` in a subprocess
with 4 forced host devices (this file's ``__main__``), starts the 4 ranks
of tests/dist_ranks_check.py, joined through a ``FileStore`` in a
temporary directory, runs the same cases with no rank grid in this process
meanwhile, and waits for every process under one join timeout (a hang
fails in seconds, never at the suite's limit).

- Stack parity, with the x-first rank grids (2, 1) and (4, 1) on the 4x2
  mesh and (2, 2) on the 2x4 mesh: `ring_shift`, the halos (serialized
  and overlapped), `migrate_axis` (plain and compressed) and the
  reductions; the 20-step windowed run at 8^3, order 3, with its
  ``mig_cap`` and ``n_local`` growths and its re-split (4x2 -> 2x4 and
  2x4 -> 4x2, the rank grid re-chosen); the checkpoints rank 0 writes
  (array for array and scalar for scalar the one process's); and the run
  restored from step 10 over the ranks: all bit-equal. On (2, 2) also the
  chaos paths: a NaN rolled back on every rank and retried, and a
  crash restored from the autosave rank 0 wrote, each bit-equal to the one
  process's run of it; and the reference's functional faces
  (`make_dist_step`, `make_dist_sort`, `make_dist_window`) on each rank's
  block.
- Reference parity, 2 ranks: the reference's 2x2 run at order 1, 8^3, 10
  steps in windows of 5; ints, slots, halts and counters exact, fields
  rtol 2e-5 / atol 1e-6, positions and momenta rtol 2e-5 / atol 2e-5,
  energies rtol 2e-5.
- Backend ``auto`` over 2 ranks whose own occupancies would choose
  differently: rank 0 alone resolves, at the mesh's occupancy, and both
  ranks hold its choice.
- Refusals by name (more ranks than cards, a rank grid that does not
  divide the mesh), and the drivers' `DeprecationWarning` when built
  without a spec.
"""

import json
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dist_ranks_check as check  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
import repro_torch.pic as tpic  # noqa: E402
from repro_torch.distributed.ranks import check_rank_grid, check_rank_request, choose_rank_grid  # noqa: E402
from repro_torch.launch import pic_run  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
JOIN_TIMEOUT_S = 240.0


# -- the reference, in the subprocess -------------------------------------------------------


def _reference_main(out_dir: str, inputs: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4 " + os.environ.get("XLA_FLAGS", "")
    import jax
    import jax.numpy as jnp

    import repro.api as rapi
    import repro.core as rcore
    import repro.pic as rpic

    inp = dict(np.load(inputs))
    spec = rapi.scenario("uniform", backend="xla", policy=rcore.SortPolicyConfig(sort_interval=20,
                                                                                  sort_trigger_perf_enable=False),
                         **check.REF_PARITY)
    parts = rpic.ParticleState(**{k: jnp.asarray(inp[f"uniform.{k}"]) for k in ("pos", "u", "w", "alive")})
    sim = rapi.make_simulation(spec, particles=parts)
    sim.run()
    st = jax.device_get(sim.state)
    arrays = {k: np.asarray(st[k]) for k in ("pos", "u", "w", "alive", "slots", "pslot", "slab_valid")}
    arrays.update({f"fields.{n}": np.asarray(f) for n, f in zip(check.FIELDS, st["fields"])})
    np.savez(os.path.join(out_dir, "reference.npz"), **arrays)
    with open(os.path.join(out_dir, "reference.json"), "w") as f:
        json.dump({"sorts": sim.sorts, "rebuilds": sim.rebuilds, "growths": dict(sim.growths),
                   "halts": dict(sim.halts), "host_step": sim._host_step, "history": sim.history,
                   "comm_stats": dict(sim.comm_stats)}, f)


# -- the fixture ----------------------------------------------------------------------------


def _wait(procs: dict, logs: Path, deadline: float) -> None:
    """Join every process by ``deadline``; on a timeout or a failure kill
    the rest and fail with the tail of each log."""
    failed = []
    for name, proc in procs.items():
        try:
            rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            rc = "timeout"
        if rc != 0:
            failed.append((name, rc))
            break
    if failed:
        for proc in procs.values():
            proc.kill()
            proc.wait()
        tails = {name: (logs / f"{name}.log").read_text()[-3000:] for name in procs}
        pytest.fail(f"{failed} (join timeout {JOIN_TIMEOUT_S} s); logs: {tails}")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results and the one process's, from one spawn."""
    tmp = tmp_path_factory.mktemp("ranks")
    inputs = str(tmp / "inputs.npz")
    check.make_inputs(inputs)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO / "src"), str(REPO / "tests"),
                                                       os.environ.get("PYTHONPATH", "")]))
    procs = {}

    def start(name, argv, **kw):
        log = open(tmp / f"{name}.log", "w")
        procs[name] = subprocess.Popen([sys.executable, *argv], env=dict(env, **kw), stdout=log,
                                       stderr=subprocess.STDOUT, cwd=str(tmp))

    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        start("reference", [__file__, "--reference", str(tmp), inputs], JAX_PLATFORMS="cpu")
        (tmp / "store").mkdir()
        for r in range(check.WORLD):
            start(f"rank{r}", [str(REPO / "tests" / "dist_ranks_check.py"), str(r), str(check.WORLD),
                               str(tmp / "store"), str(tmp), inputs], OMP_NUM_THREADS="1")
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            inp = dict(np.load(inputs))
            two_d = check.GRIDS["2x2"][0]
            one = {"primitives": {m: check.primitives(inp, None, m) for m in check.MESHES},
                   "windowed": {m: check.windowed(inp, None, str(tmp / "ckpt.one{}x{}".format(*m)), m)
                                for m in check.MESHES},
                   "ref_parity": check.ref_parity(inp, None),
                   "chaos": check.chaos(inp, None, str(tmp / "auto.one"), two_d),
                   "dist_faces": check.dist_faces(inp, None, two_d)}
        finally:
            torch.set_num_threads(n)
        _wait(procs, tmp, deadline)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    yield {"dir": tmp, "one": one}


def _load(tmp: Path, name: str):
    arrays = dict(np.load(tmp / f"{name}.npz"))
    meta = tmp / f"{name}.json"
    return arrays, (json.loads(meta.read_text()) if meta.exists() else None)


def _same_arrays(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# -- stack parity, 4 ranks ------------------------------------------------------------------


@pytest.mark.parametrize("grid", list(check.GRIDS))
def test_exchanges_and_reductions_bit_equal(runs, grid):
    ranks, _ = _load(runs["dir"], f"{grid}.primitives")
    _same_arrays(ranks, runs["one"]["primitives"][check.GRIDS[grid][0]])


@pytest.mark.parametrize("grid", list(check.GRIDS))
def test_windowed_run_with_growths_and_resplit_bit_equal(runs, grid):
    mesh = check.GRIDS[grid][0]
    arrays, scalars = _load(runs["dir"], f"{grid}.windowed")
    one_arrays, one_scalars = runs["one"]["windowed"][mesh]
    run = one_scalars["run."]
    # the run exercises what it claims: both growths and the re-split, which turns the mesh round
    assert run["growths"]["mig_cap"] >= 1 and run["growths"]["n_local"] == 1, run["growths"]
    assert run["growths"]["rebalance"] == 1 and run["mesh"] == list(mesh[::-1]), (run["growths"], run["mesh"])
    assert run["halts"]["mig_recv_dropped"] == 1 and run["discarded_steps"] == 1 and run["host_step"] == 20
    assert run["host_reads"] >= run["windows"]
    _same_arrays(arrays, one_arrays)
    # host counters and the history (reads and windows are each rank's own: equal too)
    assert json.loads(json.dumps(one_scalars)) == scalars


@pytest.mark.parametrize("grid", list(check.GRIDS))
def test_checkpoint_rank0_writes_is_the_one_process_checkpoint(runs, grid):
    mesh = check.GRIDS[grid][0]
    for step in ("step10", "step20"):
        ranks_dir, one_dir = runs["dir"] / f"ckpt.{grid}" / step, runs["dir"] / "ckpt.one{}x{}".format(*mesh) / step
        _same_arrays(dict(np.load(ranks_dir / "arrays.npz")), dict(np.load(one_dir / "arrays.npz")))
        meta, one_meta = (json.loads((d / "checkpoint.json").read_text()) for d in (ranks_dir, one_dir))
        assert meta == one_meta
    assert sorted(os.listdir(runs["dir"] / f"ckpt.{grid}")) == ["step10", "step20"]  # no stray temporaries
    # the run restored from step 10 over the ranks is the continuous run
    _, scalars = _load(runs["dir"], f"{grid}.windowed")
    one_arrays = runs["one"]["windowed"][mesh][0]
    for k in check.STATE_KEYS + tuple(f"fields.{n}" for n in check.FIELDS):
        np.testing.assert_array_equal(one_arrays[f"restored.{k}"], one_arrays[f"run.{k}"], err_msg=k)
    assert scalars["restored."]["history"] == scalars["run."]["history"]


def test_rollback_and_crash_restore_over_ranks(runs):
    arrays, scalars = _load(runs["dir"], "2x2.chaos")
    one_arrays, one_scalars = runs["one"]["chaos"]
    assert one_scalars["nan_field."]["halts"] == {"nonfinite": 1} and one_scalars["nan_field."]["retries"] == 1
    assert one_scalars["crash."]["restarts"] == 1 and one_scalars["crash."]["host_step"] == 12
    _same_arrays(arrays, one_arrays)
    assert json.loads(json.dumps(one_scalars)) == scalars


def test_functional_faces_take_a_rank_block(runs):
    ranks, _ = _load(runs["dir"], "2x2.dist_faces")
    one = runs["one"]["dist_faces"]
    assert int(one["bundle.n_done"]) == 5 and one["step2.n_migrated"] > 0
    assert one["bundle.per_step.n_migrated"][:5].min() > 0
    _same_arrays(ranks, one)


def test_auto_backend_is_rank_zeros_choice_over_the_mesh(runs):
    _, got = _load(runs["dir"], "2x1.auto_choice")
    # each rank's own occupancy would choose differently from the mesh's
    assert got["own_fill"][0] > got["mesh_fill"] >= got["own_fill"][1], got
    # rank 0 alone resolved, at the mesh's occupancy, and both ranks hold its backends
    assert got["resolutions"] == [1, 0] and got["fill"][0] == got["mesh_fill"], got
    assert got["held"] and all(held == ["cuda", "cuda"] for held in got["held"]), got


# -- reference parity, 2 ranks --------------------------------------------------------------


def test_two_ranks_match_the_reference(runs):
    port, scalars = _load(runs["dir"], "2x1.ref_parity")
    port_one, _ = runs["one"]["ref_parity"]
    _same_arrays(port, port_one)
    ref, ref_scalars = _load(runs["dir"], "reference")
    s = scalars[""]
    for key in ("sorts", "rebuilds", "growths", "halts", "host_step"):
        assert s[key] == ref_scalars[key], key
    assert s["comm_stats"] == pytest.approx(ref_scalars["comm_stats"], rel=1e-12)
    for k in ("alive", "w", "slots", "pslot", "slab_valid"):
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    for k in ("pos", "u"):
        np.testing.assert_allclose(port[k], ref[k], rtol=2e-5, atol=2e-5, err_msg=k)
    for n in check.FIELDS:
        np.testing.assert_allclose(port[f"fields.{n}"], ref[f"fields.{n}"], rtol=2e-5, atol=1e-6, err_msg=n)
    assert [h["step"] for h in s["history"]] == [h["step"] for h in ref_scalars["history"]]
    for hp, hr in zip(s["history"], ref_scalars["history"]):
        assert hp["n_alive"] == hr["n_alive"] and hp["n_moved"] == hr["n_moved"]
        for key in ("field_energy", "kinetic_energy"):
            assert hp[key] == pytest.approx(hr[key], rel=2e-5), (hp["step"], key)


# -- refusals and the grid's choice ---------------------------------------------------------


def test_rank_grid_choice_and_refusals():
    assert choose_rank_grid(2, 4, 2) == (2, 1) and choose_rank_grid(4, 4, 2) == (4, 1)
    assert choose_rank_grid(8, 4, 2) == (4, 2) and choose_rank_grid(4, 2, 4) == (2, 2)
    assert choose_rank_grid(3, 4, 2) is None
    assert check_rank_request(4, (2, 4)) == (2, 2)
    assert check_rank_request(2, (4, 2), n_cards=2) == (2, 1)
    with pytest.raises(RuntimeError, match="4 ranks need 4 cards, one a rank, but 1 are visible"):
        check_rank_request(4, (4, 2), n_cards=1)
    with pytest.raises(ValueError, match=r"no rank grid of 3 ranks divides the 4x2 mesh"):
        check_rank_request(3, (4, 2))
    with pytest.raises(ValueError, match=r"rank grid \(3, 1\) does not divide the 4x2 mesh"):
        check_rank_grid((3, 1), 4, 2)
    with pytest.raises(ValueError, match=r"rank grid \(1, 4\) does not divide the 4x2 mesh"):
        check_rank_grid((1, 4), 4, 2)
    # the launcher refuses before it starts a process: no cards here, and
    # nothing runs on the CPU in their place
    with pytest.raises(RuntimeError, match="2 ranks need 2 cards, one a rank, but 0 are visible"):
        pic_run.run_ranks(tapi.scenario("uniform", grid=(8, 8, 8), mesh="2x2"), 2)
    with pytest.raises(ValueError, match="no rank grid of 3 ranks divides the 2x2 mesh"):
        pic_run.run_ranks(tapi.scenario("uniform", grid=(8, 8, 8), mesh="2x2"), 3, device="cpu")


def test_direct_drivers_warn_and_the_facade_is_silent():
    spec = tapi.scenario("uniform", backend="torch", grid=(4, 4, 4), mesh="2x2")
    fields = tapi.build_fields(spec, device="cpu")
    parts = tapi.build_particles(spec, device="cpu")
    with pytest.warns(DeprecationWarning, match=r"Simulation\(fields, particles, config\) is deprecated"):
        tpic.Simulation(fields, parts, tapi.pic_config(spec))
    with pytest.warns(DeprecationWarning, match=r"DistSimulation\(fields, particles, config\) is deprecated"):
        tpic.DistSimulation(fields, parts, tapi.dist_config(spec), mesh_shape=(2, 2))
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        assert isinstance(tapi.make_simulation(spec, device="cpu"), tpic.DistSimulation)
        tapi.make_simulation(tapi.scenario("uniform", backend="torch", grid=(4, 4, 4)), device="cpu")


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    _reference_main(sys.argv[2], sys.argv[3])
