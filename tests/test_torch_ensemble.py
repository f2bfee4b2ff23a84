"""Port parity of the batched ensemble engine (tests/test_ensemble.py, case
by case): stacked members against the reference's vmapped ensemble and
against the port's own solo runs, per-member halt-and-grow with siblings
left bit-exact, one window built per bucket, per-member step targets,
`EnsembleSpec` construction and JSON, `spec_signature` and bucketing, the
member-indexed facade, member checkpoints across packages, and the async
simulation service; plus the launcher's ``--ensemble``/``--sweep`` and the
service's smoke run.

Both packages start from the same numpy-made particles (their random
generators differ). The reference runs its ``xla`` backend, the port its
CPU route, at the reference's sizes (6^3, order 1, 2^3 particles a cell).

Tolerances: step counts, sorts, rebuilds, growths, halts, host steps,
capacities, slots, weights, alive flags, signatures and spec JSON exact;
fields and particles against the reference rtol 2e-5 / atol 2e-5, energies
rtol 2e-5 (as tests/test_ensemble.py holds its members against sequential
runs); a member against the port's own solo run bit for bit, and a sibling
through a shared capacity growth bit for bit.
"""

import asyncio
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.api as rapi  # noqa: E402
import repro.core as rcore  # noqa: E402
import repro.pic as rpic  # noqa: E402
import repro.pic.simulation as rsimulation  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.pic as tpic  # noqa: E402
from repro_torch.checkpoint import tree_member_set, tree_member_slice  # noqa: E402
from repro_torch.launch import pic_run, sim_serve  # noqa: E402
from test_torch_sim import FIELDS, _np_particles  # noqa: E402

POLICY = dict(sort_interval=20, sort_trigger_perf_enable=False)
INTERVAL_ONLY = dict(sort_interval=10, sort_trigger_perf_enable=False, sort_trigger_empty_ratio=2.0,
                     sort_trigger_full_ratio=2.0, sort_trigger_rebuild_count=10**6)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _members(specs, shape=(6, 6, 6)):
    """(reference members, port members) from numpy: ``specs`` is a list of
    (seed, u_thermal)."""
    ref, port = [], []
    for seed, u_thermal in specs:
        p = _np_particles(shape, ppc=2, u_thermal=u_thermal, seed=seed)
        ref.append((rpic.FieldState.zeros(shape), rpic.ParticleState(**{k: jnp.asarray(v) for k, v in p.items()})))
        port.append((tpic.FieldState.zeros(shape), tpic.ParticleState(**{k: torch.from_numpy(v) for k, v in p.items()})))
    return ref, port


def _configs(*, shape=(6, 6, 6), capacity=16):
    kw = dict(dt=0.2, order=1, deposition="matrix", gather="matrix", sort_mode="incremental", capacity=capacity)
    return (rpic.PICConfig(grid=rpic.GridSpec(shape=shape), backend="xla", **kw),
            tpic.PICConfig(grid=tpic.GridSpec(shape=shape), backend="torch", **kw))


def _policies(policy):
    return rcore.SortPolicyConfig(**policy), tcore.SortPolicyConfig(**policy)


def _pair(specs, policy, *, shape=(6, 6, 6), capacity=16):
    """The same bucket in both packages: (reference, port) ensembles."""
    (ref_m, port_m), (cfg_r, cfg_t), (pol_r, pol_t) = _members(specs, shape), _configs(shape=shape, capacity=capacity), \
        _policies(policy)
    return rpic.EnsembleSimulation(ref_m, cfg_r, pol_r), tpic.EnsembleSimulation(port_m, cfg_t, pol_t)


def _solo(spec, policy, *, shape=(6, 6, 6), capacity=16):
    """The port's solo run of one member (seed, u_thermal)."""
    (_, [(fields, parts)]), (_, cfg), (_, pol) = _members([spec], shape), _configs(shape=shape, capacity=capacity), \
        _policies(policy)
    return tpic.Simulation(fields, parts, cfg, policy=pol)


def _assert_matches_reference(ref, port):
    """Counters and histories exact, member states within the windowed
    drivers' tolerance."""
    assert ref.config.capacity == port.config.capacity
    assert list(np.asarray(ref.host_step)) == list(port.host_step)
    assert (list(np.asarray(ref.sorts)), list(np.asarray(ref.rebuilds))) == (list(port.sorts), list(port.rebuilds))
    assert ref.growths == port.growths and ref.halts == port.halts
    for i in range(port.n_members):
        hr, ht = ref.histories[i], port.histories[i]
        assert [(h["step"], h["n_alive"], h["n_moved"]) for h in hr] == \
            [(h["step"], h["n_alive"], h["n_moved"]) for h in ht]
        for a, b in zip(hr, ht):
            np.testing.assert_allclose(b["field_energy"], a["field_energy"], rtol=2e-5)
            np.testing.assert_allclose(b["kinetic_energy"], a["kinetic_energy"], rtol=2e-5)
        sr, st = ref.member_state(i), port.member_state(i)
        assert int(sr.step) == st.step
        np.testing.assert_array_equal(st.layout.slots.numpy(), np.asarray(sr.layout.slots))
        np.testing.assert_array_equal(st.layout.particle_slot.numpy(), np.asarray(sr.layout.particle_slot))
        for n in ("w", "alive"):
            np.testing.assert_array_equal(getattr(st.particles, n).numpy(), np.asarray(getattr(sr.particles, n)))
        for n in ("pos", "u"):
            np.testing.assert_allclose(getattr(st.particles, n).numpy(), np.asarray(getattr(sr.particles, n)),
                                       rtol=2e-5, atol=2e-5, err_msg=f"member {i} {n}")
        for n in FIELDS:
            np.testing.assert_allclose(getattr(st.fields, n).numpy(), np.asarray(getattr(sr.fields, n)),
                                       rtol=2e-5, atol=2e-5, err_msg=f"member {i} {n}")


def _assert_bit_equal_to_solo(ens, i, solo, *, layout=True):
    """Member i of the port's ensemble against the port's solo run: every
    counter, and fields and particles bit for bit (and the bins, when the
    two share a capacity)."""
    st = ens.member_state(i)
    assert st.step == solo.state.step and int(ens.host_step[i]) == solo._host_step
    assert (int(ens.sorts[i]), int(ens.rebuilds[i])) == (solo.sorts, solo.rebuilds)
    assert ens.histories[i] == solo.history
    parts = ("fields", "particles") + (("layout", "slab") if layout else ())
    for part in parts:
        x, y = getattr(st, part), getattr(solo.state, part)
        for f in dataclasses.fields(x):
            assert torch.equal(getattr(x, f.name), getattr(y, f.name)), f"member {i} {part}.{f.name}"


# -- the stacked window against the reference's vmapped one and the solo runs --


def test_ensemble_matches_sequential():
    """3 members through one bucket: the reference's vmapped window's counts
    and states, and each member bit-equal to its own solo run."""
    specs = [(0, 0.05), (1, 0.05), (2, 0.05)]
    ref, port = _pair(specs, POLICY)
    ref.run(30, window=8, diagnostics_every=10)
    port.run(30, window=8, diagnostics_every=10)
    _assert_matches_reference(ref, port)
    assert int(port.sorts.sum() + port.rebuilds.sum()) > 0, "no member ever sorted: the test is vacuous"
    assert port.host_reads == port.windows + 2 * port.growths["capacity"]
    for i, spec in enumerate(specs):
        solo = _solo(spec, POLICY)
        solo.run(30, window=8, diagnostics_every=10)
        # a member that never halted keeps its bins at the old capacity in
        # its solo run while the bucket grew for a sibling
        _assert_bit_equal_to_solo(port, i, solo, layout=solo.config.capacity == port.config.capacity)


def test_ensemble_growth_does_not_perturb_siblings():
    """One hot member overflows its bins and the shared capacity grows: the
    hot member stays its solo run (which grows the same way), and its mild
    siblings, whose solo runs never grow, stay bit-identical to them though
    they were re-binned at the larger capacity mid-run."""
    specs = [(0, 0.5), (1, 0.02), (2, 0.02)]
    ref, port = _pair(specs, INTERVAL_ONLY, capacity=12)
    ref.run(28, window=7)
    port.run(28, window=7)
    _assert_matches_reference(ref, port)
    assert port.growths["capacity"] >= 1 and port.config.capacity > 12 and port.halts.get("bin_overflow", 0) >= 1
    assert port.host_reads == port.windows + 2 * port.growths["capacity"]
    solo_hot = _solo(specs[0], INTERVAL_ONLY, capacity=12)
    solo_hot.run(28, window=7)
    assert solo_hot.config.capacity == port.config.capacity
    _assert_bit_equal_to_solo(port, 0, solo_hot)
    for i in (1, 2):
        solo = _solo(specs[i], INTERVAL_ONLY, capacity=12)
        solo.run(28, window=7)
        assert solo.config.capacity == 12, "a mild sibling overflowed on its own: the isolation claim is vacuous"
        _assert_bit_equal_to_solo(port, i, solo, layout=False)


@pytest.mark.parametrize("order", [1, 2, 3])
def test_plain_routes_sum_the_same_at_any_capacity(order):
    """The CPU route's fused gather and fused deposition give the same bits
    for the same occupied slots at any capacity (more zero-padded slots, an
    odd count included): what keeps a re-binned sibling bit-exact."""
    from repro_torch.core.deposition import _fused_grids_torch
    from repro_torch.core.gather import _fused_gather_torch_bins

    rng = np.random.default_rng(order)
    grid, cap, g = (6, 6, 6), 12, tcore.max_guard(order)
    d = torch.from_numpy(rng.random((216, cap, 3), dtype=np.float32))
    val = torch.from_numpy(rng.standard_normal((216, cap, 3), dtype=np.float32))
    val[:, 9:] = 0.0
    padded = torch.from_numpy(rng.standard_normal((6, *(k + 2 * g for k in grid)), dtype=np.float32))
    gathered = _fused_gather_torch_bins(d, padded, grid_shape=grid, order=order, guard=g)
    deposited = _fused_grids_torch(d, val, grid_shape=grid, order=order, guard=g)
    for cap2 in (13, 24, 48):
        d2 = torch.cat([d, d[:, :1].expand(-1, cap2 - cap, -1)], dim=1).contiguous()
        val2 = torch.cat([val, torch.zeros(216, cap2 - cap, 3)], dim=1).contiguous()
        assert torch.equal(_fused_gather_torch_bins(d2, padded, grid_shape=grid, order=order, guard=g)[:, :cap],
                           gathered)
        for a, b in zip(_fused_grids_torch(d2, val2, grid_shape=grid, order=order, guard=g), deposited):
            assert torch.equal(a, b)


def test_ensemble_one_window_per_bucket():
    """A 4-member bucket builds its window once across two full windows and
    the tail (20 steps at window 8), as the reference traces its vmapped
    window once."""
    shape = (6, 6, 8)
    ref, port = _pair([(s, 0.05) for s in range(4)], POLICY, shape=shape)
    before = rsimulation._ensemble_trace_count
    ref.run(20, window=8)
    port.run(20, window=8)
    assert rsimulation._ensemble_trace_count - before == 1
    assert port.growths["capacity"] == 0, "capacity grew: the build count is not comparable"
    assert port.window_builds == 1 and port.graph_captures == 0 and port.windows == 3 and port.host_reads == 3
    assert list(port.host_step) == [20] * 4
    _assert_matches_reference(ref, port)


def test_ensemble_per_member_step_targets():
    """run() with a per-member step vector: the members stop at their own
    targets inside shared windows."""
    ref, port = _pair([(s, 0.05) for s in range(3)], POLICY)
    ref.run([5, 12, 9], window=6)
    port.run([5, 12, 9], window=6)
    assert list(port.host_step) == [5, 12, 9]
    assert [port.member_state(i).step for i in range(3)] == [5, 12, 9]
    _assert_matches_reference(ref, port)
    assert port.window_builds == 1 and port.windows == 2


def test_member_slice_is_a_view_and_set_writes_in_place():
    _, [(fields, parts)] = _members([(0, 0.05)])
    port = tpic.EnsembleSimulation([(fields, parts)] * 2, _configs()[1], _policies(POLICY)[1])
    stacked = port.state
    member = tree_member_slice(stacked, 1)
    assert member.particles.pos.data_ptr() == stacked.particles.pos[1].data_ptr()
    assert [m.particles.pos.data_ptr() for m in tpic.unstack_tree(stacked)] == \
        [stacked.particles.pos[i].data_ptr() for i in range(2)]
    ptr = stacked.fields.ex.data_ptr()
    new = dataclasses.replace(member.fields, ex=torch.full_like(member.fields.ex, 3.0))
    tree_member_set(stacked.fields, 1, new)
    assert stacked.fields.ex.data_ptr() == ptr and bool((stacked.fields.ex[1] == 3.0).all())
    assert bool((stacked.fields.ex[0] == 0.0).all())
    with pytest.raises(ValueError, match="does not fit"):
        tree_member_set(stacked.fields, 0, dataclasses.replace(new, ex=torch.zeros(5, 5, 5)))


# -- EnsembleSpec, signatures, buckets -------------------------------------------


def _specs(**kw):
    """The same base spec in both packages."""
    kw = {"grid": (6, 6, 6), "ppc": 2, "steps": 8, "window": 4, **kw}
    return rapi.scenario("uniform", backend="xla", **kw), tapi.scenario("uniform", backend="torch", **kw)


def test_ensemble_spec_replicate_and_sweep():
    base_r, base_t = _specs()
    rep = tapi.EnsembleSpec.replicate(base_t, 3)
    members = rep.members()
    assert rep.n_members == 3
    assert [m.plasma.seed for m in members] == [base_t.plasma.seed + i for i in range(3)]
    assert [m.name for m in members] == ["uniform-m0", "uniform-m1", "uniform-m2"]
    assert [m.to_json() for m in members] == [m.to_json() for m in rapi.EnsembleSpec.replicate(base_r, 3).members()]

    axes = {"order": [1, 2], "u_thermal": [0.0, 0.1]}
    sw = tapi.EnsembleSpec.sweep(base_t, axes, replicas=2)
    assert sw.n_members == 8
    assert [m.deposition.order for m in sw.members()] == [1, 1, 1, 1, 2, 2, 2, 2]
    assert len({m.plasma.seed for m in sw.members()}) == 2  # replicas staggered, points share them
    assert [m.to_json() for m in sw.members()] == \
        [m.to_json() for m in rapi.EnsembleSpec.sweep(base_r, axes, replicas=2).members()]


def test_ensemble_spec_rejects_meshes():
    """The port's SimSpec holds no mesh; a reference ensemble whose base or
    a member names one is refused as in the reference ("single-device")."""
    base_r, base_t = _specs()
    meshed = {"base": rapi.apply_overrides(base_r, mesh=(1, 2)).to_dict(), "overrides": []}
    with pytest.raises(ValueError, match="single-device"):
        tapi.EnsembleSpec.from_dict(meshed)
    with pytest.raises(ValueError, match="single-device"):
        rapi.EnsembleSpec.from_dict(meshed)
    with pytest.raises(ValueError, match="single-device"):
        tapi.EnsembleSpec(base=base_t, overrides=({"mesh": (1, 2)},)).members()
    with pytest.raises(ValueError, match="single-device"):
        rapi.EnsembleSpec(base=base_r, overrides=({"mesh": (1, 2)},)).members()


def test_ensemble_spec_json_roundtrip():
    """Byte-identical JSON in both packages, loaded both ways."""
    base_r, base_t = _specs()
    es_t = tapi.EnsembleSpec.sweep(base_t, {"density": [0.5, 1.0]}, replicas=2)
    es_r = rapi.EnsembleSpec.sweep(base_r, {"density": [0.5, 1.0]}, replicas=2)
    assert es_t.to_json() == es_r.to_json()
    back = tapi.EnsembleSpec.from_json(es_t.to_json())
    assert back == es_t and back.to_json() == es_t.to_json()
    assert [m.to_json() for m in back.members()] == [m.to_json() for m in es_t.members()]
    assert tapi.EnsembleSpec.from_json(es_r.to_json()) == es_t
    assert rapi.EnsembleSpec.from_json(es_t.to_json()) == es_r
    drift = tapi.EnsembleSpec.sweep(tapi.scenario("two_stream"), {"drift": [0.1, 0.3]})
    assert drift.to_json() == rapi.EnsembleSpec.sweep(rapi.scenario("two_stream"), {"drift": [0.1, 0.3]}).to_json()
    # a numeric drift is the drift speed along the base's axis (the
    # reference stores the bare number, which its build_particles cannot read)
    assert [m.plasma.drift for m in drift.members()] == [tapi.DriftSpec(u=0.1, axis=2), tapi.DriftSpec(u=0.3, axis=2)]


@pytest.mark.parametrize("overrides", [{}, {"order": 3, "capacity": 40}, {"sort": "global", "window": 0},
                                       {"dt": 0.123, "ckc_beta": 0.1, "policy": {"sort_interval": 7}}],
                         ids=["base", "order-capacity", "global-host-loop", "dt-policy"])
def test_spec_signature_is_the_reference_hash(overrides):
    """The same 16 hex digits as the reference for one spec JSON, under
    every backend name."""
    for backend in ("auto", "xla", "pallas", "pallas_reduced"):
        ov = dict(overrides, backend=backend)
        if "policy" in ov:
            ov["policy"] = rcore.SortPolicyConfig(**ov["policy"])
        spec_r = rapi.apply_overrides(rapi.scenario("uniform", grid=(6, 6, 8), ppc=2), **ov)
        spec_t = tapi.SimSpec.from_json(spec_r.to_json())
        assert tapi.spec_signature(spec_t) == rapi.spec_signature(spec_r)


def test_spec_signature_is_compile_shape_only():
    base_r, base = _specs()
    for ov in ({"seed": 99}, {"density": 0.25}, {"u_thermal": 0.3}):
        assert tapi.spec_signature(tapi.apply_overrides(base, **ov)) == tapi.spec_signature(base)
    for ov in ({"order": 2}, {"grid": (6, 6, 8)}, {"capacity": 64}, {"window": 8}):
        assert tapi.spec_signature(tapi.apply_overrides(base, **ov)) != tapi.spec_signature(base)
        assert tapi.spec_signature(tapi.apply_overrides(base, **ov)) == rapi.spec_signature(
            rapi.apply_overrides(base_r, **ov))
    with pytest.raises(NotImplementedError, match="mesh"):  # the port's specs hold no mesh at all
        tapi.spec_signature(tapi.apply_overrides(base, mesh=(1, 2)))
    with pytest.raises(ValueError, match="mesh"):
        rapi.spec_signature(rapi.apply_overrides(base_r, mesh=(1, 2)))


def test_bucket_specs_groups_by_signature():
    base_r, base_t = _specs()
    es = tapi.EnsembleSpec.sweep(base_t, {"order": [1, 2]}, replicas=2)
    members = es.members()
    buckets = tapi.bucket_specs(members)
    assert list(buckets.values()) == list(rapi.bucket_specs(
        rapi.EnsembleSpec.sweep(base_r, {"order": [1, 2]}, replicas=2).members()).values())
    assert len(buckets) == 2 and sorted(i for idxs in buckets.values() for i in idxs) == [0, 1, 2, 3]
    ens = tapi.make_ensemble(es, device="cpu")
    assert [s.n_members for s in ens.sims] == [2, 2]
    for i in range(4):
        b, s = ens.slot(i)
        assert ens.sims[b].specs[s] == members[i]


# -- the member-indexed facade and member checkpoints ----------------------------


def test_make_ensemble_matches_make_simulation():
    """Each member of a spec-built ensemble is the port's `make_simulation`
    of its spec, bit for bit; steps and live counts as in the reference's
    facade."""
    base_r, base_t = _specs(steps=12)
    es = tapi.EnsembleSpec.replicate(base_t, 3)
    ens = tapi.make_ensemble(es, device="cpu")
    ens.run()
    ref = rapi.make_ensemble(rapi.EnsembleSpec.replicate(base_r, 3))
    ref.run()
    for i, m in enumerate(es.members()):
        solo = tapi.make_simulation(m, device="cpu")
        solo.run()
        d_ens, d_solo, d_ref = ens.diagnostics(i), solo.diagnostics(), ref.diagnostics(i)
        assert d_ens["member"] == i and d_ens["step"] == d_solo["step"] == d_ref["step"] == 12
        assert d_ens["n_alive"] == d_solo["n_alive"] == d_ref["n_alive"]
        assert d_ens["total_energy"] == d_solo["total_energy"]
        b, s = ens.slot(i)
        _assert_bit_equal_to_solo(ens.sims[b], s, solo)


def test_member_checkpoint_roundtrip(tmp_path):
    """A member checkpoint is a standard single-driver checkpoint: the port
    loads it and continues bit-equal to the ensemble continuing; the
    reference loads it too; and it restores into a fresh ensemble slot, as a
    reference-written member checkpoint does."""
    base_r, base_t = _specs(steps=8)
    es = tapi.EnsembleSpec.replicate(base_t, 3)
    ens = tapi.make_ensemble(es, device="cpu")
    ens.run()
    path = str(tmp_path / "m1")
    ens.save_member(1, path)
    saved = ens.member_state(1)
    pos8, ez8 = saved.particles.pos.clone(), saved.fields.ez.clone()

    solo = tapi.load_simulation(path, device="cpu")
    assert solo.state.step == 8 and solo._host_step == 8
    assert torch.equal(solo.state.particles.pos, pos8)
    solo.run(4)
    ens.run(4)
    b, s = ens.slot(1)
    _assert_bit_equal_to_solo(ens.sims[b], s, solo)

    ref_solo = rapi.load_simulation(path)
    assert int(ref_solo.state.step) == 8 and ref_solo._host_step == 8
    np.testing.assert_array_equal(np.asarray(ref_solo.state.particles.pos), pos8.numpy())

    fresh = tapi.make_ensemble(es, device="cpu")
    fresh.restore_member(1, path)
    b, s = fresh.slot(1)
    assert int(fresh.sims[b].host_step[s]) == 8
    assert torch.equal(fresh.member_state(1).fields.ez, ez8)

    ref = rapi.make_ensemble(rapi.EnsembleSpec.replicate(base_r, 3))
    ref.run()
    ref_path = str(tmp_path / "ref_m2")
    ref.save_member(2, ref_path)
    fresh.restore_member(2, ref_path)
    got, want = fresh.member_state(2), ref.member_state(2)
    assert got.step == int(want.step) == 8
    for n in FIELDS:
        np.testing.assert_array_equal(getattr(got.fields, n).numpy(), np.asarray(getattr(want.fields, n)))
    for n in ("pos", "u", "w", "alive"):
        np.testing.assert_array_equal(getattr(got.particles, n).numpy(), np.asarray(getattr(want.particles, n)))
    np.testing.assert_array_equal(got.layout.slots.numpy(), np.asarray(want.layout.slots))


def test_member_restore_rebins_on_capacity_mismatch(tmp_path):
    """A member saved at capacity C restores into an ensemble at 2C,
    re-binned without a permutation; a member too dense for a smaller
    capacity is refused."""
    _, base_t = _specs(steps=6)
    es = tapi.EnsembleSpec.replicate(base_t, 2)
    ens = tapi.make_ensemble(es, device="cpu")
    ens.run()
    path = str(tmp_path / "m0")
    ens.save_member(0, path)
    cap = ens.sims[0].config.capacity

    wide = tapi.make_ensemble(tapi.EnsembleSpec.replicate(tapi.apply_overrides(base_t, capacity=2 * cap), 2),
                              device="cpu")
    wide.restore_member(0, path)
    st = wide.member_state(0)
    assert st.layout.capacity == 2 * cap and st.step == 6
    assert torch.equal(st.particles.pos, ens.member_state(0).particles.pos)
    # a permutation-free re-bin keeps each bin's occupied slots a prefix
    occupied = (st.layout.slots >= 0).int()
    assert bool((occupied[:, 1:] <= occupied[:, :-1]).all())

    # a hot member's bins overflow 12 and its bucket grows; a fresh bucket at
    # 12 (its initial lattice holds 8 a cell) cannot take it back
    hot = tapi.EnsembleSpec.replicate(tapi.apply_overrides(base_t, capacity=12, u_thermal=0.5, steps=10), 2)
    grown = tapi.make_ensemble(hot, device="cpu")
    grown.run()
    assert grown.sims[0].growths["capacity"] >= 1
    grown.save_member(0, str(tmp_path / "hot"))
    narrow = tapi.make_ensemble(hot, device="cpu")
    assert narrow.sims[0].config.capacity == 12
    with pytest.raises(ValueError, match="denser than the ensemble capacity"):
        narrow.restore_member(0, str(tmp_path / "hot"))


# -- the async simulation service ---------------------------------------------------


def _service_base():
    return tapi.scenario("uniform", grid=(4, 4, 4), ppc=1, steps=4, window=2, backend="torch")


def test_sim_service_batches_and_streams():
    """Two same-signature jobs make one batch (one ensemble over one cached
    window store); a third of another shape runs in its own. Every job
    streams at least one window event, then done. A repeat batch of the
    same signature and size builds no window."""
    base = _service_base()
    other = tapi.apply_overrides(base, order=2)

    async def body():
        svc = sim_serve.SimService(max_batch=4, batch_wait=0.25, device="cpu")
        await svc.start()
        ids = [await svc.submit(base.to_json()), await svc.submit(base.to_json()), await svc.submit(other.to_json())]
        finals, windows = {}, {}
        for job_id in ids:
            windows[job_id] = 0
            async for event in svc.results(job_id):
                assert event["job"] == job_id
                if event["event"] == "window":
                    windows[job_id] += 1
                else:
                    finals[job_id] = event
        builds = svc.window_builds
        again = [await svc.submit(base.to_json()), await svc.submit(base.to_json())]
        for job_id in again:
            async for event in svc.results(job_id):
                finals[job_id] = event
        await svc.close()
        return svc, ids, again, finals, windows, builds

    svc, ids, again, finals, windows, builds = asyncio.run(body())
    for job_id in ids + again:
        assert finals[job_id]["event"] == "done" and finals[job_id]["diagnostics"]["step"] == 4
    assert all(windows[j] >= 1 for j in ids)
    assert [finals[j]["batch_size"] for j in ids + again] == [2, 2, 1, 2, 2]
    assert finals[ids[0]]["signature"] != finals[ids[2]]["signature"]
    assert svc.batches_run == 3 and svc.jobs_done == 5
    assert svc.cache.stats()["misses"] == 2 and svc.cache.stats()["hits"] == 1
    assert builds == 2 and svc.window_builds == 2  # the repeat batch copied into the cached window
    assert finals[again[0]]["history"] == finals[ids[0]]["history"]


def test_sim_service_surfaces_bad_specs_and_errors():
    async def body():
        svc = sim_serve.SimService(device="cpu")
        await svc.start()
        with pytest.raises(Exception):
            await svc.submit("{not json")
        await svc.close()

    asyncio.run(body())

    cache = sim_serve.ExecutableCache(maxsize=2)
    entries = [cache.get(sig) for sig in ("a", "b", "c")]
    assert cache.stats() == {"size": 2, "maxsize": 2, "hits": 0, "misses": 3, "evictions": 1}
    assert cache.get("c") is entries[2]  # the most recent survives
    assert cache.get("a") is not entries[0]  # evicted: a fresh store


def test_sim_service_admission_and_cancel():
    """A bounded service rejects an over-quota submit with a terminal event;
    cancel drops a queued job at once (freeing its admission slot) and cuts
    a running job's stream to a terminal cancelled event; the worker skips
    jobs cancelled while queued."""
    base = _service_base()

    async def body():
        svc = sim_serve.SimService(max_batch=1, batch_wait=0.05, max_queue=1, device="cpu")
        j1 = await svc.submit(base.to_json())  # the worker is not started: no race
        j2 = await svc.submit(base.to_json())  # over the bound
        ev2 = [e async for e in svc.results(j2)]
        assert [e["event"] for e in ev2] == ["rejected"]
        assert ev2[0]["queued"] == 1 and ev2[0]["max_queue"] == 1
        assert svc.jobs[j2].status == "rejected"

        assert svc.cancel(j1) == "cancelled"
        ev1 = [e async for e in svc.results(j1)]
        assert [e["event"] for e in ev1] == ["cancelled"] and ev1[0]["was"] == "queued"
        assert (svc.queued, svc.rejected, svc.cancelled) == (0, 1, 1)
        j3 = await svc.submit(base.to_json())  # admitted again
        assert svc.jobs[j3].status == "queued"

        # running cancel: drive the batch as the worker thread would, so the
        # running phase is deterministic
        loop = asyncio.get_running_loop()
        job = svc.jobs[j3]
        job.status = "running"
        svc.queued -= 1
        assert svc.cancel(j3) == "cancelling"
        await loop.run_in_executor(None, svc._run_batch, [job], loop)
        ev3 = [e async for e in svc.results(j3)]
        assert [e["event"] for e in ev3] == ["cancelled"] and ev3[0]["was"] == "running"

        await svc.start()  # j1 still sits in the queue, cancelled
        j4 = await svc.submit(base.to_json())
        ev4 = [e async for e in svc.results(j4)]
        assert ev4[-1]["event"] == "done"
        await svc.close()
        return svc

    svc = asyncio.run(body())
    assert svc.jobs_done == 1


def test_sim_serve_smoke_runs_on_the_cpu(capsys):
    assert sim_serve.main(["--smoke", "--device", "cpu", "--grid", "4", "--steps", "4", "--window", "2"]) == 0
    assert "-> OK" in capsys.readouterr().out


# -- the launcher ------------------------------------------------------------------------


def test_launcher_dumps_and_runs_an_ensemble(tmp_path, capsys):
    """``--sweep``/``--ensemble`` write the reference's EnsembleSpec JSON and
    run one bucket with one host read a window."""
    path = tmp_path / "ens.json"
    pic_run.main(["--scenario", "two_stream", "--sweep", "drift=0.1,0.2", "--ensemble", "2", "--dump-spec", str(path)])
    want = rapi.EnsembleSpec.sweep(rapi.scenario("two_stream"), {"drift": [0.1, 0.2]}, replicas=2)
    assert path.read_text() == want.to_json()
    assert pic_run.parse_sweeps(["density=0.5,1", "order=1"]) == {"density": [0.5, 1], "order": [1]}
    with pytest.raises(ValueError, match="not a flat override"):
        pic_run.parse_sweeps(["colour=1,2"])
    capsys.readouterr()
    pic_run.main(["--scenario", "uniform", "--grid", "4", "4", "4", "--steps", "6", "--window", "3", "--ensemble",
                  "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "ensemble of 3 members in 1 shape bucket(s)" in out
    assert "host reads 2 in 2 windows, captures 0, growths 0" in out
    assert out.count(": step 6,") == 3
