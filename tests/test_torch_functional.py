"""Port parity of the functional faces: `pic_step`, `pic_run_window`,
`ensemble_run_window` and `make_ensemble_window_fn` against the
reference's, the window's contract (donation, device-side ``n_target`` and
``step``, its store of windows), the distributed builders on the CPU
against the port's own drivers, the package-level names against the
reference's ``__init__`` files, the checkpoint checksums, and the slab
staging counter.

Both packages start from the same numpy-made particles. The reference
runs its ``xla`` backend, the port its CPU route. The grids and time steps
here are ones no trace-counting test of the reference uses
(tests/test_sim_loop.py, tests/test_ensemble.py, and
tests/test_torch_ensemble.py), so a window compiled here is never a cache
hit there.

Tolerances (tests/test_sim_loop.py's): slots, particle slots, weights,
alive flags, counters, halt codes and steps, sort decisions and reasons
exact; fields, positions, momenta and energies rtol 2e-5 (atol 2e-5 for
particles and 1e-6 for fields); the port against its own `Simulation`
bit for bit.
"""

import ast
import dataclasses
import importlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as rcore  # noqa: E402
import repro.pic as rpic  # noqa: E402
import repro.pic.simulation as rsimulation  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.pic as tpic  # noqa: E402
import repro_torch.pic.simulation as tsimulation  # noqa: E402
from repro_torch.core import binning as tbinning  # noqa: E402
from repro_torch.pic.simulation import bundle_to_host  # noqa: E402
from test_torch_sim import FIELDS, _np_particles  # noqa: E402

SHAPE, DT = (4, 6, 8), 0.15          # the single-device window's cell
ENS_SHAPE = (4, 6, 6)                # the ensemble's
POLICY = dict(sort_interval=4, min_sort_interval=2, sort_trigger_perf_enable=False)
INT_ROWS = ("active", "sorted", "reason", "n_moved", "n_alive")
HEAD = ("n_done", "n_sorts", "n_rebuilds", "overflow_pending", "halt_code", "halt_step", "halt_inv")
SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config_pair(shape, *, sort_mode="incremental", capacity=16, order=2, **kw):
    common = dict(dt=DT, order=order, deposition="matrix", gather="matrix", sort_mode=sort_mode, capacity=capacity,
                  **kw)
    return (rpic.PICConfig(grid=rpic.GridSpec(shape=shape), backend="xla", **common),
            tpic.PICConfig(grid=tpic.GridSpec(shape=shape), backend="torch", **common))


def _state_pair(shape, cfg_r, cfg_t, *, u_thermal=0.05, seed=0):
    """The same initial state in both packages (fields from a small seeded
    perturbation, so the energies are not all zero)."""
    p = _np_particles(shape, ppc=2, u_thermal=u_thermal, seed=seed)
    rng = np.random.default_rng(seed + 100)
    f = {n: (1e-3 * rng.standard_normal(shape)).astype(np.float32) for n in FIELDS}
    st_r, of_r = rpic.init_state(rpic.FieldState(*(jnp.asarray(f[n]) for n in FIELDS)),
                                 rpic.ParticleState(**{k: jnp.asarray(v) for k, v in p.items()}), cfg_r)
    st_t, of_t = tpic.init_state(tpic.FieldState(*(torch.from_numpy(f[n].copy()) for n in FIELDS)),
                                 tpic.ParticleState(**{k: torch.from_numpy(v.copy()) for k, v in p.items()}), cfg_t)
    assert of_r == of_t == 0
    return st_r, st_t


def _policies():
    return rcore.SortPolicyConfig(**POLICY), tcore.SortPolicyConfig(**POLICY)


def _assert_bundle(b_r, b_t):
    """The reference's fetched bundle against the port's, read on the host
    in one read."""
    import jax

    b_r, h = jax.device_get(b_r), bundle_to_host(b_t)
    for key in HEAD:
        np.testing.assert_array_equal(h[key], np.asarray(b_r[key]), err_msg=key)
    for key in ("halt_measured", "halt_reference"):
        np.testing.assert_allclose(h[key], np.asarray(b_r[key]), rtol=2e-5, err_msg=key)
    for key in INT_ROWS:
        np.testing.assert_array_equal(h["per_step"][key], np.asarray(b_r["per_step"][key]), err_msg=key)
    for key in ("field_energy", "kinetic_energy"):
        np.testing.assert_allclose(h["per_step"][key], np.asarray(b_r["per_step"][key]), rtol=2e-5, err_msg=key)
    assert set(h["per_step"]) == set(b_r["per_step"]) == set(tsimulation.PER_STEP_NAMES)
    return h


def _assert_state(st_r, st_t, member=None):
    pick = (lambda a: np.asarray(a)) if member is None else (lambda a: np.asarray(a)[member])
    port = (lambda t: t.numpy()) if member is None else (lambda t: t[member].numpy())
    np.testing.assert_array_equal(port(st_t.step), pick(st_r.step))
    np.testing.assert_array_equal(port(st_t.layout.slots), pick(st_r.layout.slots))
    np.testing.assert_array_equal(port(st_t.layout.particle_slot), pick(st_r.layout.particle_slot))
    for n in ("w", "alive"):
        np.testing.assert_array_equal(port(getattr(st_t.particles, n)), pick(getattr(st_r.particles, n)))
    for n in ("pos", "u"):
        np.testing.assert_allclose(port(getattr(st_t.particles, n)), pick(getattr(st_r.particles, n)),
                                   rtol=2e-5, atol=2e-5, err_msg=n)
    for n in FIELDS:
        np.testing.assert_allclose(port(getattr(st_t.fields, n)), pick(getattr(st_r.fields, n)), rtol=2e-5,
                                   atol=1e-6, err_msg=n)


def _tensors(tree) -> list:
    """A tree's tensors, its ``step`` aside (an int or a tensor)."""
    out = []
    for f in dataclasses.fields(tree):
        v = None if f.name == "step" else getattr(tree, f.name)
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif dataclasses.is_dataclass(v):
            out += _tensors(v)
    return out


def _snapshot(*trees) -> list:
    return [t.clone() for tree in trees for t in _tensors(tree)]


def _unchanged(snap, *trees) -> bool:
    return all(torch.equal(a, b) for a, b in zip(snap, [t for tree in trees for t in _tensors(tree)]))


# -- pic_step ------------------------------------------------------------------------------


def test_pic_step_matches_reference():
    """One step under the reference's names; the donating variant is the
    same function, and neither writes its input."""
    cfg_r, cfg_t = _config_pair(SHAPE)
    st_r, st_t = _state_pair(SHAPE, cfg_r, cfg_t)
    snap = _snapshot(st_t)
    new_r, stats_r = rsimulation.pic_step(st_r, cfg_r)
    new_t, stats_t = tpic.pic_step(st_t, cfg_t)
    assert tpic.pic_step_donated is tpic.pic_step
    assert _unchanged(snap, st_t) and new_t.step == 1
    for f in dataclasses.fields(stats_t):
        assert int(getattr(stats_t, f.name)) == int(getattr(stats_r, f.name)), f.name
    np.testing.assert_allclose(new_t.fields.ex.numpy(), np.asarray(new_r.fields.ex), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(new_t.layout.slots.numpy(), np.asarray(new_r.layout.slots))


# -- pic_run_window ----------------------------------------------------------------------


@pytest.mark.parametrize("sort_mode", ["incremental", "global"])
def test_pic_run_window_matches_reference(sort_mode):
    """A full window of 10 steps, sorts included, and the same window with
    the energies off: bundle and state against the reference's."""
    cfg_r, cfg_t = _config_pair(SHAPE, sort_mode=sort_mode)
    pol_r, pol_t = _policies()
    st_r, st_t = _state_pair(SHAPE, cfg_r, cfg_t)
    for with_energies in (True, False):
        out_r = rpic.pic_run_window(st_r, rcore.policy_init(), cfg_r, 10, policy=pol_r, donate=False,
                                    with_energies=with_energies)
        out_t = tpic.pic_run_window(st_t, tcore.policy_init(), cfg_t, 10, policy=pol_t, donate=False,
                                    with_energies=with_energies)
        h = _assert_bundle(out_r[2], out_t[2])
        _assert_state(out_r[0], out_t[0])
        assert h["n_done"] == 10 and h["per_step"]["sorted"].any()
        if sort_mode == "incremental":
            assert h["n_sorts"] > 0 and (h["per_step"]["reason"] == 3).any()
        if not with_energies:
            assert not h["per_step"]["field_energy"].any()
        for f in dataclasses.fields(out_t[1]):
            np.testing.assert_array_equal(getattr(out_t[1], f.name).numpy(), np.asarray(getattr(out_r[1], f.name)))


@pytest.mark.parametrize("as_tensor", [False, True], ids=["int", "tensor"])
def test_pic_run_window_n_target(as_tensor):
    """``n_target=4`` in a window of 10, as an int and as a 0-d tensor: four
    steps run, the rest of the rows are zero; a tensor ``step`` on input
    comes back advanced."""
    cfg_r, cfg_t = _config_pair(SHAPE)
    pol_r, pol_t = _policies()
    st_r, st_t = _state_pair(SHAPE, cfg_r, cfg_t)
    n_target = torch.tensor(4) if as_tensor else 4
    if as_tensor:
        st_t = dataclasses.replace(st_t, step=torch.tensor(7, dtype=torch.int32))
        st_r = dataclasses.replace(st_r, step=jnp.int32(7))
    out_r = rpic.pic_run_window(st_r, rcore.policy_init(), cfg_r, 10, policy=pol_r, donate=False, n_target=4)
    out_t = tpic.pic_run_window(st_t, tcore.policy_init(), cfg_t, 10, policy=pol_t, donate=False, n_target=n_target)
    h = _assert_bundle(out_r[2], out_t[2])
    assert h["n_done"] == 4 and list(h["per_step"]["active"]) == [True] * 4 + [False] * 6
    assert int(out_t[0].step) == (11 if as_tensor else 4)
    _assert_state(out_r[0], out_t[0])


def test_pic_run_window_overflow_halt():
    """A sort that still overflows halts the window: the halt code, step and
    ``overflow_pending`` against the reference's."""
    cfg_r, cfg_t = _config_pair(SHAPE, capacity=9, order=1)
    pol_r, pol_t = _policies()
    st_r, st_t = _state_pair(SHAPE, cfg_r, cfg_t, u_thermal=0.5)
    out_r = rpic.pic_run_window(st_r, rcore.policy_init(), cfg_r, 10, policy=pol_r, donate=False)
    out_t = tpic.pic_run_window(st_t, tcore.policy_init(), cfg_t, 10, policy=pol_t, donate=False)
    h = _assert_bundle(out_r[2], out_t[2])
    assert h["halt_code"] == tcore.HALT_BIN_OVERFLOW and h["overflow_pending"] and h["n_done"] < 10
    assert h["n_rebuilds"] >= 1 and h["halt_step"] == h["n_done"]
    _assert_state(out_r[0], out_t[0])


def test_pic_run_window_sentinel_halt():
    """The sentinel on and a NaN written into ``ez`` before step 3: the
    window halts there with the reference's code, step, invariant and
    values."""
    from repro.distributed.fault import FAULT_NAN_FIELD

    cfg_r, cfg_t = _config_pair(SHAPE)
    pol_r, pol_t = _policies()
    st_r, st_t = _state_pair(SHAPE, cfg_r, cfg_t)
    vec = np.array([FAULT_NAN_FIELD, 3, 2])
    out_r = rpic.pic_run_window(st_r, rcore.policy_init(), cfg_r, 8, policy=pol_r, donate=False,
                                health=rcore.HealthConfig(enable=True), fault_vec=jnp.asarray(vec, jnp.int32))
    out_t = tpic.pic_run_window(st_t, tcore.policy_init(), cfg_t, 8, policy=pol_t, donate=False,
                                health=tcore.HealthConfig(enable=True), fault_vec=torch.from_numpy(vec))
    h = _assert_bundle(out_r[2], out_t[2])
    assert h["halt_code"] == tcore.HALT_NONFINITE and h["halt_step"] == 4 and h["n_done"] == 4
    assert not h["overflow_pending"]


def test_pic_run_window_contract_and_simulation():
    """``donate=False`` leaves the inputs bit-unchanged and returns tensors
    no later call writes; ``donate=True`` hands back the caller's own
    tensors; a second call builds no window; the result is bit-equal to a
    `Simulation` window of the same steps from the same state."""
    _, cfg_t = _config_pair(SHAPE)
    _, pol_t = _policies()
    p = _np_particles(SHAPE, ppc=2, u_thermal=0.05, seed=3)
    fields = tpic.FieldState.zeros(SHAPE)
    sim = tpic.Simulation(fields, tpic.ParticleState(**{k: torch.from_numpy(v.copy()) for k, v in p.items()}), cfg_t,
                          policy=pol_t)
    state, pstate = sim.state, sim.policy_state
    snap = _snapshot(state, pstate)
    fn = tsimulation.WindowFn()
    out, pout, bundle = fn(state, pstate, cfg_t, 9, policy=pol_t, donate=False)
    assert _unchanged(snap, state, pstate)
    kept = _snapshot(out, pout)
    again = fn(state, pstate, cfg_t, 9, policy=pol_t, donate=False, n_target=2)
    assert fn.builds == 1 and _unchanged(kept, out, pout) and int(again[2]["n_done"]) == 2
    sim.run(9, window=9, diagnostics_every=1)
    h = bundle_to_host(bundle)
    assert (h["n_sorts"], h["n_rebuilds"]) == (sim.sorts, sim.rebuilds) and sim.sorts > 0
    assert list(h["per_step"]["n_moved"]) == [r["n_moved"] for r in sim.history]
    assert list(h["per_step"]["field_energy"]) == [np.float32(r["field_energy"]) for r in sim.history]
    assert int(out.step) == sim.state.step == 9
    assert _unchanged(_snapshot(sim.state, sim.policy_state), out, pout)
    # donated: the caller's tensors come back, holding the result
    mine = (tsimulation._clone_tree(state.fields), tsimulation._clone_tree(state.particles))
    st = dataclasses.replace(state, fields=mine[0], particles=mine[1], layout=tsimulation._clone_tree(state.layout),
                             slab=tsimulation._clone_tree(state.slab))
    res = fn(st, tsimulation._clone_tree(pstate), cfg_t, 9, policy=pol_t, donate=True)
    assert res[0].fields is mine[0] and torch.equal(mine[0].ex, out.fields.ex) and fn.builds == 1


def test_shared_faces_keep_only_the_latest_window():
    """`pic_run_window`'s store holds the window of its latest call only: a
    call with other statics frees the one before; `clear_windows` frees the
    last. A callable of its own keeps up to ``SLOTS`` windows."""
    _, cfg_t = _config_pair(SHAPE)
    _, pol_t = _policies()
    p = _np_particles(SHAPE, ppc=1, u_thermal=0.05, seed=5)
    state, _ = tsimulation.init_state(tpic.FieldState.zeros(SHAPE),
                                      tpic.ParticleState(**{k: torch.from_numpy(v) for k, v in p.items()}), cfg_t)
    pstate = tcore.policy_init()
    store = tsimulation._PIC_WINDOWS
    tpic.clear_windows()
    for n in (2, 3, 2):
        tpic.pic_run_window(state, pstate, cfg_t, n, policy=pol_t, donate=False)
        assert len(store.store) == 1 and store.last.key[2] == n
    tpic.clear_windows()
    assert not store.store and store.last is None
    fn = tsimulation.WindowFn()
    for n in range(1, fn.SLOTS + 3):
        fn(state, pstate, cfg_t, n, policy=pol_t, donate=False)
    assert len(fn.store) == fn.SLOTS and fn.builds == fn.SLOTS + 2
    assert [w.key[2] for w in fn.store.values()] == list(range(3, fn.SLOTS + 3))


def test_launches_counted_later_stay_one_tensor_a_device():
    """`kernels.add_launches_later` (a functional window's launch count,
    known only on the device) adds into one running total a device: the
    pending state does not grow with the number of calls, and the counts
    read afterwards hold every call."""
    from repro_torch import kernels

    kernels.reset_launch_counts()
    vec = kernels.launch_vector({"fused_bin_gather": 2, "segment_accumulate": 1}, "cpu")
    for i in range(500):
        kernels.add_launches_later(vec, torch.tensor(i % 3, dtype=torch.int32))
        assert list(kernels._PENDING) == [torch.device("cpu")] and kernels._PENDING[vec.device].shape == vec.shape
    n = sum(i % 3 for i in range(500))
    counts = kernels.launch_counts()
    assert not kernels._PENDING
    assert counts == {name: {"fused_bin_gather": 2 * n, "segment_accumulate": n}.get(name, 0) for name in counts}
    kernels.reset_launch_counts()


# -- ensemble_run_window -----------------------------------------------------------------


def _ensemble_pair(specs, capacity):
    cfg_r, cfg_t = _config_pair(ENS_SHAPE, capacity=capacity, order=1)
    pairs = [_state_pair(ENS_SHAPE, cfg_r, cfg_t, u_thermal=u, seed=s) for s, u in specs]
    st_r = rpic.stack_trees(*(r for r, _ in pairs))
    st_t = tpic.stack_trees(*(t for _, t in pairs))
    st_t = dataclasses.replace(st_t, step=0)
    ps_r = rpic.stack_trees(*(rcore.policy_init() for _ in specs))
    ps_t = tpic.stack_trees(*(tcore.policy_init() for _ in specs))
    return (cfg_r, st_r, ps_r), (cfg_t, st_t, ps_t)


def test_ensemble_run_window_matches_reference():
    """Three stacked members with targets 6, 3 and 0 (member 0 hot: it
    overflows and halts): every bundle leaf with its member axis against the
    reference's vmapped window; member 2 bit-unchanged."""
    (cfg_r, st_r, ps_r), (cfg_t, st_t, ps_t) = _ensemble_pair([(0, 0.5), (1, 0.05), (2, 0.05)], capacity=9)
    pol_r, pol_t = _policies()
    before = _snapshot(tsimulation._member_tree(st_t.fields, 2), tsimulation._member_tree(st_t.particles, 2))
    out_r = rpic.ensemble_run_window(st_r, ps_r, cfg_r, 8, policy=pol_r, donate=False,
                                     n_target=jnp.asarray([6, 3, 0], jnp.int32))
    out_t = tpic.ensemble_run_window(st_t, ps_t, cfg_t, 8, policy=pol_t, donate=False, n_target=[6, 3, 0])
    h = _assert_bundle(out_r[2], out_t[2])
    assert h["halt_code"].shape == (3,) and h["per_step"]["n_moved"].shape == (3, 8)
    assert h["halt_code"][0] == tcore.HALT_BIN_OVERFLOW and list(h["halt_code"][1:]) == [0, 0]
    assert list(h["n_done"][1:]) == [3, 0] and h["n_done"][0] <= 6
    for i in range(3):
        _assert_state(out_r[0], out_t[0], member=i)
    assert _unchanged(before, tsimulation._member_tree(out_t[0].fields, 2),
                      tsimulation._member_tree(out_t[0].particles, 2))


def test_ensemble_bucket_runs_in_its_window_buffers():
    """After its first window an `EnsembleSimulation`'s state is its
    window's buffers, so later windows copy nothing in or out and run in
    place, as a `Simulation`'s do; its members stay bit-equal to a bucket
    that runs the same steps in one window."""
    import repro_torch.api as tapi

    spec = tapi.scenario("uniform", grid=ENS_SHAPE, order=1, ppc=2, u_thermal=0.05, dt=DT, backend="torch",
                         policy=tcore.SortPolicyConfig(**POLICY))
    ens = tapi.make_ensemble(tapi.EnsembleSpec.sweep(spec, {}, replicas=2), device="cpu").sims[0]
    ens.run(3, window=3)
    buf = ens._window.buffers
    assert ens._state.particles.pos is buf.particles.pos and ens.policy_state is buf.pstate
    ptrs = [t.data_ptr() for t in (buf.particles.pos, buf.fields.ex, buf.layout.slots)]
    ens.run(3, window=3)
    assert ens._window.buffers is buf and ens._state.particles.pos is buf.particles.pos
    assert [t.data_ptr() for t in (ens._state.particles.pos, ens._state.fields.ex, ens._state.layout.slots)] == ptrs
    assert ens.window_builds == 1 and ens.bucket_steps == 6
    one = tapi.make_ensemble(tapi.EnsembleSpec.sweep(spec, {}, replicas=2), device="cpu").sims[0]
    one.run(6, window=6)
    for i in range(2):
        a, b = ens.member_state(i), one.member_state(i)
        assert all(torch.equal(getattr(a.particles, f.name), getattr(b.particles, f.name))
                   for f in dataclasses.fields(a.particles))
        assert torch.equal(a.fields.ex, b.fields.ex) and a.step == b.step == 6


def test_ensemble_window_fns_share_no_window():
    """Two `make_ensemble_window_fn` callables each build their own window;
    a second call of one builds none. Health and fault vectors are refused
    by name."""
    _, (cfg_t, st_t, ps_t) = _ensemble_pair([(0, 0.05), (1, 0.05)], capacity=16)
    _, pol_t = _policies()
    a, b = tpic.make_ensemble_window_fn(), tpic.make_ensemble_window_fn(donate=False)
    a(st_t, ps_t, cfg_t, 3, policy=pol_t, donate=False)
    b(st_t, ps_t, cfg_t, 3, policy=pol_t)
    b(st_t, ps_t, cfg_t, 3, policy=pol_t, n_target=[1, 2])
    assert (a.builds, b.builds) == (1, 1) and a.last is not b.last
    assert not set(map(id, a.store.values())) & set(map(id, b.store.values()))
    with pytest.raises(ValueError, match="health"):
        tpic.ensemble_run_window(st_t, ps_t, cfg_t, 3, health=tcore.HealthConfig(enable=True))
    with pytest.raises(ValueError, match="fault_vec"):
        tpic.ensemble_run_window(st_t, ps_t, cfg_t, 3, fault_vec=torch.tensor([1, 1, 0]))


# -- the distributed builders, against the port's drivers ---------------------------------


def _dist_sim():
    import repro_torch.api as tapi

    spec = tapi.scenario("uniform", grid=(8, 8, 8), order=1, ppc=2, u_thermal=0.05, mesh=(2, 2), backend="torch",
                         policy=tcore.SortPolicyConfig(**POLICY))
    return tapi.make_simulation(spec, device="cpu")


def test_dist_builders_match_the_drivers():
    """`make_dist_window` (8 steps, ``n_target=5``) bit-equal to a
    `DistSimulation` window of 5, `make_dist_step` (3 steps) to its
    host-driven loop, and `make_dist_sort` to `dist_global_sort_device`;
    a mesh that is not a pair of shard counts is refused."""
    from repro_torch.pic.dist_simulation import DIAG_NAMES, make_dist_window
    from repro_torch.pic.distributed import dist_global_sort_device, make_dist_sort, make_dist_step

    sim = _dist_sim()
    clone = lambda: {k: (tuple(f.clone() for f in v) if k == "fields" else v.clone()) for k, v in sim.state.items()}
    st = clone()
    ps = tsimulation._clone_tree(sim.policy_state)
    keys = ("fields", "pos", "u", "w", "alive", "slots", "pslot", "slab_d", "slab_valid", "mid_pos", "mid_u")
    win = make_dist_window((2, 2), sim.config, sim.policy, 8)
    mine = clone()  # donated: the result comes back in these tensors
    out = win(*(mine[k] for k in keys), ps, 5, 0, 0, 0, 1, None)
    assert all(a is b for a, b in zip(out[0], mine["fields"])) and out[1] is mine["pos"] and out[11] is ps
    h = bundle_to_host(out[-1])
    assert h["n_done"] == 5 and list(h["per_step"]) == list(DIAG_NAMES) and not h["per_step"]["active"][5:].any()
    ref = _dist_sim()
    bundles = []
    enter = ref._enter_window
    ref._enter_window = lambda *a: bundles.append(enter(*a)) or bundles[-1]
    ref.run(5, window=5, diagnostics_every=1)
    for k, got in zip(keys, out[:11]):
        want = ref.state[k]
        assert all(torch.equal(a, b) for a, b in zip(got, want)) if k == "fields" else torch.equal(got, want), k
    for name in DIAG_NAMES:
        assert np.array_equal(h["per_step"][name][:5], bundles[0]["per_step"][name]), name
    assert (h["n_sorts"], h["n_rebuilds"]) == (ref.sorts, ref.rebuilds)

    step = make_dist_step((2, 2), sim.config)
    cur = tuple(st[k] for k in keys[:9])
    for _ in range(3):
        *cur, stats = step(*cur)
    host = _dist_sim()
    host.run(3, window=None)
    assert all(torch.equal(a, host.state[k]) for a, k in zip(cur[1:], keys[1:9]))
    assert set(stats) == set(tpic.distributed.STAT_KEYS)
    got = make_dist_sort((2, 2), sim.config)(*cur[1:5])
    want = dist_global_sort_device(*cur[1:5], sim.config)
    assert len(got) == 9 and all(torch.equal(a, b) for a, b in zip(got, want))
    for bad in (None, (2,), (2, 0), "2x2"):
        with pytest.raises(TypeError, match="pair"):
            make_dist_step(bad, sim.config)


# -- package-level names --------------------------------------------------------------------

# the reference's JAX-only names (ROADMAP conventions): the TPU interpret
# switch and VMEM budget, and the jax.sharding.Mesh builder
JAX_ONLY = {"repro.kernels": {"autodetect_interpret", "choose_block_cells"}, "repro.pic": {"make_pic_mesh"}}
PACKAGES = {"repro.pic": "repro_torch.pic", "repro.core": "repro_torch.core", "repro.kernels": "repro_torch.kernels",
            "repro.checkpoint": "repro_torch.checkpoint"}


def _public_names(package: str) -> set[str]:
    """The public names a package's ``__init__`` imports or defines, read
    from its source."""
    tree = ast.parse((SRC / package.replace(".", "/") / "__init__.py").read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {a.asname or a.name.split(".")[0] for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("package", list(PACKAGES))
def test_reference_package_names_exist_in_port(package):
    port = importlib.import_module(PACKAGES[package])
    names = _public_names(package)
    assert names, package
    missing = sorted(n for n in names - JAX_ONLY.get(package, set()) if not hasattr(port, n))
    assert not missing, f"{PACKAGES[package]} lacks {missing}"


def test_checksums_match_reference():
    """The same arrays give the same crc32 strings in both packages, and a
    changed byte or a short manifest the same messages."""
    import repro.checkpoint as rckpt
    import repro_torch.checkpoint as tckpt

    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal((3, 5)).astype(np.float32), np.arange(7, dtype=np.int32),
              np.asfortranarray(rng.random((4, 3))), np.array(True)]
    sums = tckpt.array_checksums(arrays)
    assert sums == rckpt.array_checksums(arrays) and all(len(s) == 8 for s in sums)
    bad = [a.copy() for a in arrays]
    bad[1][3] += 1
    for args in ((bad, sums, ["a", "b", "c", "d"], "here"), (arrays, sums[:3], ["a"], "there")):
        with pytest.raises(ValueError) as want:
            rckpt.verify_checksums(*args)
        with pytest.raises(ValueError) as got:
            tckpt.verify_checksums(*args)
        assert str(got.value) == str(want.value)
    tckpt.verify_checksums(arrays, sums, ["a", "b", "c", "d"], "fine")


# -- the slab staging counter ----------------------------------------------------------------


def _slab_builds_per_step(deposition, gather, order):
    _, cfg = _config_pair((4, 4, 4), order=order)
    cfg = dataclasses.replace(cfg, deposition=deposition, gather=gather)
    p = _np_particles((4, 4, 4), ppc=2, u_thermal=0.05, seed=0)
    state, _ = tpic.init_state(tpic.FieldState.zeros((4, 4, 4)),
                               tpic.ParticleState(**{k: torch.from_numpy(v) for k, v in p.items()}), cfg)
    before = tbinning.SLAB_BUILDS
    new, _ = tsimulation._pic_step(state, cfg)
    return tbinning.SLAB_BUILDS - before, new


def test_one_slab_staging_per_fused_step():
    """The fused gather and deposition stage the slab once a step (the
    reference's tests/test_fused_gather.py check)."""
    assert _slab_builds_per_step("matrix", "matrix", 2)[0] == 1


def test_one_slab_staging_with_scatter_deposition():
    assert _slab_builds_per_step("scatter", "matrix", 1)[0] == 1


def test_unfused_modes_stage_no_shared_slab():
    n, new = _slab_builds_per_step("matrix_unfused", "matrix_unfused", 1)
    assert n == 0 and new.slab is None
