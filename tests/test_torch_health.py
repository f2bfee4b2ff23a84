"""Port parity of fault tolerance: the health sentinel's classification and
non-finite counts, the chaos harness's injectors and `PICFaultInjector`, the
supervisor's chaos paths of tests/test_health.py (its set-up: ``uniform``
8^3, 12 steps, window 6, diagnostics every 3), autosave directories across
packages, and `SimCheckpointer` and `clean_stale_tmp`.

Both packages start from the same numpy-made particles; the reference runs
its ``xla`` backend (``pallas_reduced`` for the demotion ladder), the port
its CPU route.

Tolerances: halt codes, invariants, halts, retries, restarts, firings, the
error's fields, step counts and directory listings are exact; the
sentinel's measured and reference values equal as float32; the injectors'
arrays are exact; a recovered run is bit-equal to the port's clean run and
within the windowed-run tolerances of tests/test_torch_sim.py (rtol 2e-5)
of the reference's clean run.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.api as rapi  # noqa: E402
import repro.pic as rpic  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
import repro_torch.pic as tpic  # noqa: E402
from repro.api.facade import SimCheckpointer as RefCheckpointer  # noqa: E402
from repro.checkpoint import clean_stale_tmp as ref_clean_stale_tmp  # noqa: E402
from repro.core import health as rhealth  # noqa: E402
from repro.distributed import fault as rfault  # noqa: E402
from repro_torch.core import health as thealth  # noqa: E402
from repro_torch.distributed import fault as tfault  # noqa: E402
from test_torch_sim import FIELDS, _assert_runs, _assert_states, _np_particles  # noqa: E402

GRID, STEPS, WINDOW = (8, 8, 8), 12, 6
PARTICLES = _np_particles(GRID, seed=11)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref(backend="xla", **overrides):
    spec = rapi.scenario("uniform", grid=GRID, steps=STEPS, window=WINDOW, diagnostics_every=3, backend=backend,
                         **overrides)
    fields = rapi.build_fields(spec)
    return rapi.make_simulation(spec, fields=fields,
                                particles=rpic.ParticleState(**{k: jnp.asarray(v) for k, v in PARTICLES.items()}))


def _port(backend="torch", **overrides):
    spec = tapi.scenario("uniform", grid=GRID, steps=STEPS, window=WINDOW, diagnostics_every=3, backend=backend,
                         **overrides)
    return tapi.make_simulation(
        spec, particles=tpic.ParticleState(**{k: torch.from_numpy(v.copy()) for k, v in PARTICLES.items()}),
        device="cpu")


@pytest.fixture(scope="module")
def clean():
    """The sentinel-off run in both packages: (reference, port)."""
    torch.set_num_threads(1)
    sim_r, sim_t = _ref(), _port()
    sim_r.run()
    sim_t.run()
    return sim_r, sim_t


def _assert_bit_equal(a, b):
    assert a.state.step == b.state.step and a._host_step == b._host_step
    for part in ("fields", "particles", "layout", "slab"):
        x, y = getattr(a.state, part), getattr(b.state, part)
        for f in dataclasses.fields(x):
            assert torch.equal(getattr(x, f.name), getattr(y, f.name)), f"{part}.{f.name}"
    assert a.history == b.history


def _assert_recovered(sim_t, clean):
    """Bit-equal to the port's clean run, and within the windowed
    tolerances of the reference's clean run."""
    ref_clean, port_clean = clean
    _assert_bit_equal(sim_t, port_clean)
    assert (sim_t.sorts, sim_t.rebuilds, sim_t.growths) == (ref_clean.sorts, ref_clean.rebuilds, ref_clean.growths)
    _assert_states(ref_clean, sim_t)


def test_clean_runs_agree(clean):
    _assert_runs(*clean)


# -- the sentinel's classification --------------------------------------------------

CFG_ON = dict(enable=True)
CLASSIFY_CASES = [
    (CFG_ON, {}),
    (CFG_ON, dict(fields_nonfinite=3, momenta_nonfinite=2, charge=2.0)),
    (CFG_ON, dict(momenta_nonfinite=2, charge=2.0)),
    (CFG_ON, dict(charge=1.001)),
    (CFG_ON, dict(charge=1.00009)),
    (CFG_ON, dict(energy=2.0)),
    (CFG_ON, dict(energy=1.2)),
    (CFG_ON, dict(energy=1.25, charge=float("inf"))),
    (CFG_ON, dict(charge=float("nan"))),
    (CFG_ON, dict(energy=float("nan"), energy_ref=0.0)),
    (CFG_ON, dict(energy=0.0009, energy_ref=0.0)),
    (CFG_ON, dict(energy=0.0011, energy_ref=-0.0)),
    (CFG_ON, dict(charge=-3.0, charge_ref=-3.0003)),
    (CFG_ON, dict(charge=1e-9, charge_ref=0.0)),
    (dict(enable=True, check_charge=False, check_energy=False), dict(charge=5.0, energy=9.0)),
    (dict(enable=True, check_nonfinite=False), dict(fields_nonfinite=4, energy=float("nan"))),
    (dict(enable=True, charge_rtol=0.5, energy_rtol=0.01, energy_atol=1.0), dict(charge=1.4, energy=1.5)),
]


@pytest.mark.parametrize("cfg,kw", CLASSIFY_CASES, ids=[str(i) for i in range(len(CLASSIFY_CASES))])
def test_classify_health_matches_reference(cfg, kw):
    args = dict(fields_nonfinite=0, momenta_nonfinite=0, charge=1.0, charge_ref=1.0, energy=1.0, energy_ref=1.0)
    args.update(kw)
    counts = ("fields_nonfinite", "momenta_nonfinite")
    got = thealth.classify_health(thealth.HealthConfig(**cfg), **{
        k: torch.tensor(v, dtype=torch.int32 if k in counts else torch.float32) for k, v in args.items()})
    want = rhealth.classify_health(rhealth.HealthConfig(**cfg), **{
        k: jnp.asarray(v, jnp.int32 if k in counts else jnp.float32) for k, v in args.items()})
    assert [t.dtype for t in got] == [torch.int32, torch.int32, torch.float32, torch.float32]
    assert (int(got[0]), int(got[1])) == (int(want[0]), int(want[1]))
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w, np.float32))


def test_nonfinite_count_matches_reference():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(50, 3)).astype(np.float32)
    b = rng.normal(size=(50, 3)).astype(np.float32)
    f = rng.normal(size=(4, 5, 6)).astype(np.float32)
    a[[1, 7, 7, 30], [0, 1, 2, 2]] = [np.nan, np.inf, -np.inf, np.nan]
    b[[2, 49], [1, 0]] = np.nan
    f[0, 1, 2] = f[3, 4, 5] = np.inf
    mask = rng.random(50) > 0.3
    mask[[1, 49]] = [False, True]
    for arrays, m in (([a, b], mask), ([a, b], None), ([f], None), ([f, a], None)):
        got = thealth.nonfinite_count([torch.from_numpy(x) for x in arrays],
                                      mask=None if m is None else torch.from_numpy(m))
        want = rhealth.nonfinite_count([jnp.asarray(x) for x in arrays], mask=None if m is None else jnp.asarray(m))
        assert got.dtype == torch.int32 and int(got) == int(want) > 0
    assert thealth.HALT_NAMES == rhealth.HALT_NAMES and thealth.INVARIANT_NAMES == rhealth.INVARIANT_NAMES


# -- the chaos harness ----------------------------------------------------------------


def test_injectors_match_reference():
    rng = np.random.default_rng(4)
    fields = [rng.normal(size=(3, 4, 5)).astype(np.float32) for _ in range(6)]
    u = rng.normal(size=(20, 3)).astype(np.float32)
    w = rng.random(20).astype(np.float32)
    vecs = [[0, -1, 0], [1, 5, 2], [1, 5, 5], [1, 6, 0], [2, 5, 0], [3, 5, 0], [4, 5, 0]]
    for vec in vecs:
        for step in (4, 5):
            tv, rv = torch.tensor(vec), jnp.asarray(vec, jnp.int32)
            ts, rs = torch.tensor(step), jnp.int32(step)
            got = tfault.inject_fields(tuple(torch.from_numpy(x) for x in fields), ts, tv)
            want = rfault.inject_fields(tuple(jnp.asarray(x) for x in fields), rs, rv)
            for g, x in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(x))
            np.testing.assert_array_equal(tfault.inject_momenta(torch.from_numpy(u), ts, tv).numpy(),
                                          np.asarray(rfault.inject_momenta(jnp.asarray(u), rs, rv)))
            np.testing.assert_array_equal(tfault.inject_weights(torch.from_numpy(w), ts, tv).numpy(),
                                          np.asarray(rfault.inject_weights(jnp.asarray(w), rs, rv)))
            assert int(tfault.injected_recv_drop(ts, tv)) == int(rfault.injected_recv_drop(rs, rv))
    assert tfault.no_fault_vec().tolist() == np.asarray(rfault.no_fault_vec()).tolist()
    assert tfault.FAULT_KINDS == rfault.FAULT_KINDS and tfault.FIELD_COMPONENTS == rfault.FIELD_COMPONENTS


@pytest.mark.parametrize("spec", [dict(kind="nan_field", step=7, component="by"), dict(kind="charge_scale", step=3),
                                  dict(kind="nan_momentum", step=5, count=2), dict(kind="crash", step=8),
                                  dict(kind="nan_field", step=4, count=0), dict(kind="recv_drop", step=0)],
                         ids=["nan_field", "charge_scale", "count-2", "crash", "persistent", "recv_drop"])
def test_fault_injector_sequences_match_reference(spec):
    """The same calls (window_vec, maybe_crash, note_halt over a run of
    windows, halts at and beside the fault's step) give the same answers."""
    calls = [("vec", 0, 6), ("crash", 0, 6), ("halt", 4, 8), ("vec", 6, 6), ("crash", 6, 6), ("halt", 4, 8),
             ("halt", 4, spec["step"] + 1), ("vec", 0, 12), ("crash", 0, 12), ("halt", 4, spec["step"] + 1),
             ("vec", spec["step"], 1), ("crash", spec["step"], 1), ("vec", spec["step"] + 1, 4)]
    seqs = []
    for mod in (tfault, rfault):
        inj, seq = mod.PICFaultInjector(mod.FaultSpec(**spec)), []
        for what, a, b in calls:
            if what == "vec":
                v = inj.window_vec(a, b)
                seq.append(None if v is None else np.asarray(v).tolist())
            elif what == "crash":
                try:
                    inj.maybe_crash(a, b)
                    seq.append("ok")
                except mod.SimulatedFailure as e:
                    seq.append(str(e))
            else:
                inj.note_halt(a, b)
            seq.append((inj.fired, inj.remaining))
        seqs.append(seq)
    assert seqs[0] == seqs[1]


def test_health_and_fault_specs_match_reference():
    for cls_t, cls_r, kw in ((thealth.HealthConfig, rhealth.HealthConfig, dict(enable=True, energy_rtol=0.5)),
                             (tfault.FaultSpec, rfault.FaultSpec, dict(kind="nan_field", step=3, component="by"))):
        assert [(f, getattr(cls_t(**kw), f)) for f in cls_t.__dataclass_fields__] == \
            [(f, getattr(cls_r(**kw), f)) for f in cls_r.__dataclass_fields__]
    with pytest.raises(ValueError, match="unknown keys"):
        thealth.HealthConfig.from_dict({"enable": True, "typo_key": 1})
    with pytest.raises(ValueError):
        tfault.FaultSpec(kind="meteor_strike", step=0)
    with pytest.raises(ValueError, match="recv_drop"):
        tapi.scenario("uniform", fault={"kind": "recv_drop", "step": 1})


# -- the supervisor's chaos paths ------------------------------------------------------


def test_autosave_requires_windowed_driver():
    with pytest.raises(ValueError, match="windowed driver"):
        _port().run(4, window=None, autosave_every=2)


@pytest.mark.parametrize("fault,halts", [
    (None, {}),
    (dict(kind="nan_field", step=7, component="ez"), {"nonfinite": 1}),
    (dict(kind="charge_scale", step=7), {"invariant": 1}),
], ids=["no-fault", "nan_field", "charge_scale"])
def test_recovery_matches_reference(fault, halts, clean):
    """The sentinel on: without a fault nothing changes; a fault halts once,
    the window rolls back and retries clean; the run ends bit-equal to the
    unfaulted one, one host read per window entered."""
    kw = dict(health={"enable": True}) if fault is None else dict(health={"enable": True}, fault=fault)
    sim_r, sim_t = _ref(**kw), _port(**kw)
    sim_r.run()
    sim_t.run()
    assert sim_t.halts == sim_r.halts == halts
    assert (sim_t.retries, sim_t.restarts, sim_t.discarded_steps) == (sim_r.retries, sim_r.restarts,
                                                                     sim_r.discarded_steps)
    assert sim_t._host_step == sim_r._host_step == STEPS
    if fault is not None:
        assert sim_t.fault_injector.fired == sim_r.fault_injector.fired == 1
    assert sim_t.host_reads == sim_t.windows == STEPS // WINDOW + 2 * len(halts)
    _assert_recovered(sim_t, clean)


@pytest.mark.parametrize("backends,max_retries,last", [(("xla", "torch"), 3, "torch"),
                                                       (("pallas_reduced", "cuda_reduced"), 6, "torch")],
                         ids=["exhaustion", "demotion-ladder"])
def test_persistent_fault_matches_reference(backends, max_retries, last):
    """count=0: the fault fires on every retry; the ladder (halve, sort,
    demote cuda_reduced -> cuda -> torch) runs out the same way in both
    packages, and the error names the same halt, step, invariant and
    retries."""
    kw = dict(health={"enable": True, "max_retries": max_retries},
              fault={"kind": "nan_field", "step": 4, "component": "ex", "count": 0})
    errs = []
    for sim in (_ref(backends[0], **kw), _port(backends[1], **kw)):
        with pytest.raises((rhealth.SimulationHealthError, thealth.SimulationHealthError)) as exc:
            sim.run()
        e = exc.value
        errs.append((e.halt, e.step, e.invariant, e.retries, sim.retries, sim.halts, sim._host_step,
                     sim.fault_injector.fired))
    assert errs[0] == errs[1]
    assert errs[1][:3] == ("nonfinite", 5, "fields_nonfinite")
    assert sim.config.backend == last


def test_crash_restores_latest_autosave(clean, tmp_path):
    """A crash at step 8: the port restores its latest autosave and resumes
    bit-equal; each package's autosave restores in the other."""
    kw = dict(health={"enable": True}, fault={"kind": "crash", "step": 8})
    sim_r, sim_t = _ref(**kw), _port(**kw)
    sim_r.run(autosave_every=WINDOW, autosave_path=str(tmp_path / "ref"))
    sim_t.run(autosave_every=WINDOW, autosave_path=str(tmp_path / "port"))
    assert sim_t.restarts == sim_r.restarts == 1
    assert (sim_t.retries, sim_t.halts, sim_t._host_step) == (sim_r.retries, sim_r.halts, sim_r._host_step)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "ref"))
    _assert_recovered(sim_t, clean)
    latest_t = tapi.SimCheckpointer(sim_t, str(tmp_path / "port"), every=WINDOW).latest_path()
    latest_r = RefCheckpointer(sim_r, str(tmp_path / "ref"), every=WINDOW).latest_path()
    into_r = _ref(health={"enable": True})
    rapi.restore_simulation(into_r, latest_t)
    into_t = _port(health={"enable": True})
    tapi.restore_simulation(into_t, latest_r)
    assert into_r._host_step == into_t._host_step == STEPS and into_r.restarts == into_t.restarts == 1
    for n in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(into_r.state.fields, n)),
                                      getattr(sim_t.state.fields, n).numpy())
    np.testing.assert_array_equal(into_t.state.particles.u.numpy(), np.asarray(sim_r.state.particles.u))
    # and runs on from there in the port
    into_t.run(2)
    assert into_t._host_step == STEPS + 2


def test_crash_without_autosave_raises():
    kw = dict(health={"enable": True}, fault={"kind": "crash", "step": 2})
    msgs = []
    for sim in (_ref(**kw), _port(**kw)):
        with pytest.raises(RuntimeError, match="injected crash") as exc:
            sim.run()
        msgs.append((str(exc.value), sim.restarts, sim._host_step))
    assert msgs[0] == msgs[1]


# -- autosave bookkeeping ------------------------------------------------------------


def test_simcheckpointer_cadence_and_gc_match_reference(clean, tmp_path):
    sim_r, sim_t = clean
    answers, listings = [], []
    for cls, sim, root in ((RefCheckpointer, sim_r, tmp_path / "ref"), (tapi.SimCheckpointer, sim_t, tmp_path / "port")):
        ck = cls(sim, str(root), every=5, keep=2)
        answers.append([ck.maybe_save(0, force=True), ck.maybe_save(3), ck.maybe_save(6), ck.maybe_save(8),
                        ck.maybe_save(11), ck.maybe_save(16), ck.maybe_save(17, force=True)])
        listings.append((sorted(os.listdir(root)), os.path.basename(ck.latest_path())))
    assert answers[0] == answers[1] == [True, False, True, False, True, True, True]
    assert listings[0] == listings[1] == (["step_000000016", "step_000000017"], "step_000000017")
    with pytest.raises(FileNotFoundError):
        tapi.SimCheckpointer(sim_t, str(tmp_path / "empty"), every=1).latest_path()
    with pytest.raises(ValueError):
        tapi.SimCheckpointer(sim_t, str(tmp_path / "x"), every=0)


def test_clean_stale_tmp_matches_reference(tmp_path):
    out = []
    for fn, root in ((ref_clean_stale_tmp, tmp_path / "ref"), (tapi.clean_stale_tmp, tmp_path / "port")):
        root.mkdir()
        for name in ("step_000000005.tmp-3999999", f"step_000000006.tmp-{os.getpid()}", "step_000000004",
                     "step_000000007.old-3999998", "cache.json.tmp-x"):
            (root / name).mkdir()
        (root / "note.tmp-3999997").write_text("x")
        removed = sorted(os.path.basename(r) for r in fn(str(root)))
        out.append((removed, sorted(os.listdir(root))))
    assert out[0] == out[1]
    assert f"step_000000006.tmp-{os.getpid()}" in out[1][1] and "step_000000005.tmp-3999999" in out[1][0]
    assert tapi.clean_stale_tmp(str(tmp_path / "missing")) == []
