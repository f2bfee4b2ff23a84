"""The ensemble bucket's one step over a member axis: the kernel wrappers
with a member axis against one call a member, one wrapper call a bucket
step whatever the member count, members that are not active left
bit-unchanged, the batched window against the reference's vmapped window
(`repro.pic.EnsembleSimulation`, backend ``xla``) across deposition and
sort modes, and the dispatcher's ``batch`` key.

Inputs are seeded numpy arrays, handed to both packages. Sizes: 6^3 and
4x4x16 cells (no reference test counts its traces at either), orders 1-3,
at most 4 members.

Tolerances: a wrapper with a member axis against one call a member, and a
member against its solo run, bit for bit; against the reference: slots,
particle slots, step counts, sorts, rebuilds and growths exact, fields,
particles and energies rtol 2e-5 (as tests/test_ensemble.py holds its
members to sequential runs).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as rcore  # noqa: E402
import repro.pic as rpic  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.pic as tpic  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.deposition import ops as dep  # noqa: E402
from repro_torch.kernels.gather import ops as gat  # noqa: E402
from test_torch_ensemble import _assert_matches_reference  # noqa: E402
from test_torch_sim import _np_particles  # noqa: E402

POLICY = dict(sort_interval=12, min_sort_interval=4, sort_trigger_perf_enable=False)
SHAPES = ((6, 6, 6), (4, 4, 16))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _slab(rng, b, n_cells, cap, fill=0.6):
    """(d, val) (B, C, cap, 3): offsets in [0, 1), values on a random
    prefix of each bin's slots, gap slots 0 (as the driver's slab)."""
    d = rng.random((b, n_cells, cap, 3), dtype=np.float32)
    val = rng.standard_normal((b, n_cells, cap, 3), dtype=np.float32)
    occupied = np.arange(cap) < rng.integers(0, int(cap * fill) + 1, (b, n_cells, 1))
    return torch.from_numpy(d), torch.from_numpy(np.where(occupied[..., None], val, 0.0).astype(np.float32))


# -- the kernel wrappers with a member axis ----------------------------------------


@pytest.mark.parametrize("shape", SHAPES, ids=["6x6x6", "4x4x16"])
@pytest.mark.parametrize("order", [1, 2, 3])
def test_wrappers_with_member_axis_equal_member_calls(order, shape):
    """Each of the five bin-kernel wrappers, given B = 3 members at once on
    the CPU, gives each member the bits of a call on that member alone."""
    rng = np.random.default_rng(order)
    b, cap, g = 3, 12, tcore.max_guard(order)
    n_cells = int(np.prod(shape))
    d, val = _slab(rng, b, n_cells, cap)
    padded = torch.from_numpy(rng.standard_normal((b, 6, *(k + 2 * g for k in shape)), dtype=np.float32))
    m, n = tcore.support(order, True)[0], tcore.support(order, False)[0] ** 2
    a = torch.from_numpy(rng.standard_normal((b, n_cells, cap, m), dtype=np.float32))
    bb = torch.from_numpy(rng.standard_normal((b, n_cells, cap, n), dtype=np.float32))
    nb = torch.from_numpy(rng.standard_normal((b, n_cells, m, n), dtype=np.float32))
    calls = {
        "fused_bin_deposit": (lambda *x: dep.fused_bin_deposit(*x, order=order), (d, val)),
        "fused_bin_deposit_reduced": (
            lambda *x: dep.fused_bin_deposit_reduced(*x, order=order, grid_shape=shape, guard=g), (d, val)),
        "fused_bin_gather": (lambda *x: gat.fused_bin_gather(*x, grid_shape=shape, order=order, guard=g),
                             (d, padded)),
        "bin_outer_product": (dep.bin_outer_product, (a, bb)),
        "bin_gather": (gat.bin_gather, (a, bb, nb)),
    }
    for name, (fn, args) in calls.items():
        batched = fn(*args)
        assert batched.shape[0] == b, name
        for i in range(b):
            assert torch.equal(batched[i], fn(*(x[i] for x in args))), f"{name}, member {i}"


def test_wrappers_refuse_mismatched_member_axes():
    d, val = _slab(np.random.default_rng(0), 2, 96, 8)
    with pytest.raises(ValueError, match="padded"):
        gat.fused_bin_gather(d, torch.zeros(6, 6, 6, 20), grid_shape=(4, 4, 6), order=1, guard=1)
    with pytest.raises(ValueError, match="match"):
        dep.fused_bin_deposit(d, val[0], order=1)
    with pytest.raises(ValueError, match="g must be"):
        gat.bin_gather(torch.zeros(2, 5, 4, 3), torch.zeros(2, 5, 4, 4), torch.zeros(2, 5, 4, 3))


def test_launch_geometry_counts_the_members():
    """The fused gather's and the reduced deposition's launches cover every
    member's columns, and a single member's geometry is what it was."""
    for shape, order, cap in (((4, 4, 64), 1, 16), ((128, 128, 128), 3, 32), ((8, 8, 64), 1, 48)):
        one = gat.gather_geometry(shape, order, cap)
        assert one == gat.gather_geometry(shape, order, cap, members=1) and one.members == 1
        for b in (2, 12):
            many = gat.gather_geometry(shape, order, cap, members=b)
            runs = -(-shape[2] // many.run)
            assert many.blocks == b * shape[0] * shape[1] * runs and many.run >= one.run
            assert dep.reduced_geometry(shape, order, members=b).n_cols == b * shape[0] * shape[1]
    # the sweep's member: 16 columns give 512 blocks of 2 cells alone, 384 of
    # 32 cells for 12 members at once
    assert gat.gather_geometry((4, 4, 64), 1, 16).run == 2
    assert gat.gather_geometry((4, 4, 64), 1, 16, members=12).run == 32


# -- the bucket step -----------------------------------------------------------------


def _port_members(specs, shape, ppc=2):
    out = []
    for seed, u_thermal in specs:
        p = _np_particles(shape, ppc=ppc, u_thermal=u_thermal, seed=seed)
        out.append((tpic.FieldState.zeros(shape),
                    tpic.ParticleState(**{k: torch.from_numpy(v) for k, v in p.items()})))
    return out


def _assert_member_is_solo(ens, i, solo):
    """Member i against its solo run: counters, histories, and fields,
    particles, bins and (where the step carries one) slab bit for bit."""
    st = ens.member_state(i)
    assert st.step == solo.state.step and (int(ens.sorts[i]), int(ens.rebuilds[i])) == (solo.sorts, solo.rebuilds)
    assert ens.histories[i] == solo.history
    for part in ("fields", "particles", "layout", "slab"):
        x, y = getattr(st, part), getattr(solo.state, part)
        assert (x is None) == (y is None), part
        for f in dataclasses.fields(x) if x is not None else ():
            assert torch.equal(getattr(x, f.name), getattr(y, f.name)), f"member {i} {part}.{f.name}"


def _config(shape, **kw):
    kw = dict(dict(dt=0.2, order=1, deposition="matrix", gather="matrix", sort_mode="incremental", capacity=16,
                   backend="torch"), **kw)
    return tpic.PICConfig(grid=tpic.GridSpec(shape=shape), **kw)


ROUTES = {
    # the card's default route, and its packed-deposition rung, on the CPU
    # through the wrappers' plain versions
    "cuda_reduced": (dict(backend="cuda_reduced"), {"fused_bin_deposit_reduced": 1, "fused_bin_gather": 1}),
    "cuda": (dict(backend="cuda"), {"fused_bin_deposit": 1, "fused_bin_gather": 1}),
    "matrix_unfused": (dict(deposition="matrix_unfused", gather="matrix_unfused", backend="cuda"),
                       {"bin_outer_product": 3, "bin_gather": 6}),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_bucket_step_calls_each_wrapper_once(route, monkeypatch):
    """A bucket step calls each kernel wrapper of its route as often as a
    solo step does, whatever the member count (the card launches each
    kernel once a bucket step), and each member stays bit-equal to its solo
    run."""
    kw, per_step = ROUTES[route]
    calls = dict.fromkeys(per_step, 0)
    for name in per_step:
        mod = dep if hasattr(dep, name) else gat
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(mod, name, counted)
    shape, specs, steps = (4, 4, 16), [(0, 0.1), (1, 0.1), (2, 0.1)], 6
    cfg = _config(shape, **kw)
    ens = tpic.EnsembleSimulation(_port_members(specs, shape), cfg, tcore.SortPolicyConfig(**POLICY))
    ens.run(steps, window=4, diagnostics_every=2)
    assert ens.bucket_steps == steps and list(ens.host_step) == [steps] * 3
    assert calls == {k: v * steps for k, v in per_step.items()}
    for i, (fields, parts) in enumerate(_port_members(specs, shape)):
        solo = tpic.Simulation(fields, parts, cfg, policy=tcore.SortPolicyConfig(**POLICY))
        solo.run(steps, window=4, diagnostics_every=2)
        _assert_member_is_solo(ens, i, solo)


def _snapshot(ens, i):
    st = ens.member_state(i)
    trees = [st.fields, st.particles, st.layout, st.slab, ens.member_policy_state(i)]
    return [getattr(t, f.name).clone() for t in trees for f in dataclasses.fields(t)]


def test_members_that_are_not_active_stay_bit_unchanged():
    """A member whose target is 0 passes a window through bit-unchanged;
    a member that halts (its bins overflow) keeps its halting step's state
    while its siblings run on, as its solo window does."""
    shape = (6, 6, 6)
    specs = [(0, 0.05), (1, 0.6), (2, 0.05)]
    cfg = _config(shape, capacity=10)
    policy = tcore.SortPolicyConfig(**POLICY)
    ens = tpic.EnsembleSimulation(_port_members(specs, shape), cfg, policy)
    before = _snapshot(ens, 1)
    ens.run([5, 0, 7], window=8)
    assert list(ens.host_step) == [5, 0, 7] and ens.bucket_steps == 7
    assert all(torch.equal(a, b) for a, b in zip(before, _snapshot(ens, 1)))

    # one window of 12 steps: the hot member halts inside it, the others not
    ens = tpic.EnsembleSimulation(_port_members(specs, shape), cfg, policy)
    host = ens._enter_window(np.array([12, 12, 12]), 12, 0)
    n_done, codes = list(host["n_done"]), list(host["halt_code"])
    assert codes[1] != 0 and n_done[1] < 12 and n_done[0] == n_done[2] == 12, (n_done, codes)
    solo = tpic.Simulation(*_port_members(specs[1:2], shape)[0], cfg, policy=policy)
    bundle = solo._run_window(12, with_energies=False, n_diag=12)
    assert bundle["n_done"] == n_done[1] and bundle["halt_code"] == codes[1]
    st = ens.member_state(1)
    for part in ("fields", "particles", "layout", "slab"):
        x, y = getattr(st, part), getattr(solo.state, part)
        for f in dataclasses.fields(x):
            assert torch.equal(getattr(x, f.name), getattr(y, f.name)), f"{part}.{f.name}"
    for f in dataclasses.fields(solo.policy_state):
        assert torch.equal(getattr(ens.member_policy_state(1), f.name), getattr(solo.policy_state, f.name))


# -- against the reference's vmapped window --------------------------------------------


MODES = [("matrix", "matrix", "incremental", 1), ("matrix", "matrix", "rebuild", 2),
         ("matrix_unfused", "matrix_unfused", "incremental", 1), ("scatter", "scatter", "global", 1),
         ("rhocell", "scatter", "incremental", 2)]


@pytest.mark.parametrize("deposition,gather,sort_mode,order", MODES,
                         ids=["-".join(map(str, m)) for m in MODES])
def test_batched_window_matches_reference(deposition, gather, sort_mode, order):
    """Three members at 4x4x16 through the bucket's batched window against
    the reference's vmapped window: slots, particle slots, counters and
    histories exact, states and energies within rtol 2e-5."""
    shape, specs = (4, 4, 16), [(10, 0.08), (11, 0.08), (12, 0.08)]
    kw = dict(dt=0.2, order=order, deposition=deposition, gather=gather, sort_mode=sort_mode, capacity=16)
    ref_members, port_members = [], []
    for seed, u_thermal in specs:
        p = _np_particles(shape, ppc=2, u_thermal=u_thermal, seed=seed)
        ref_members.append((rpic.FieldState.zeros(shape),
                            rpic.ParticleState(**{k: jnp.asarray(v) for k, v in p.items()})))
        port_members.append((tpic.FieldState.zeros(shape),
                             tpic.ParticleState(**{k: torch.from_numpy(v) for k, v in p.items()})))
    ref = rpic.EnsembleSimulation(ref_members, rpic.PICConfig(grid=rpic.GridSpec(shape=shape), backend="xla", **kw),
                                  rcore.SortPolicyConfig(**POLICY))
    port = tpic.EnsembleSimulation(port_members, _config(shape, **kw), tcore.SortPolicyConfig(**POLICY))
    ref.run(14, window=7, diagnostics_every=2)
    port.run(14, window=7, diagnostics_every=2)
    _assert_matches_reference(ref, port)
    if sort_mode == "incremental":
        assert int(port.sorts.sum() + port.rebuilds.sum()) > 0, "no member sorted: the decisions go untested"


# -- the dispatcher's batch key ------------------------------------------------------


def test_dispatch_key_batch():
    """``batch=1`` keys are the keys they were (cache entries stay valid);
    a batched key appends ``|batch{B}``, is its own memo entry, and its
    thunks time [B, ...] operands. An ensemble prewarms at its member
    count."""
    key = dispatch.make_key("deposit_fused", device="cpu", order=3, grid_shape=(128, 128, 128), capacity=32)
    assert key.batch == 1
    assert key.cache_key() == "deposit_fused|order3|grid128x128x128|cap32|bins2097152|float32|cpu"
    batched = dataclasses.replace(key, batch=3)
    assert batched.cache_key() == key.cache_key() + "|batch3" and batched != key
    small = dispatch.make_key("deposit_fused", device="cpu", order=1, grid_shape=(2, 2, 4), capacity=8, batch=3)
    d, val = dispatch._synthetic_slab(small, torch.device("cpu"))
    assert d.shape == val.shape == (3, 16, 8, 3)
    for op in ("deposit_fused", "gather_fused", "deposit_unfused", "bin_gather"):
        for name, backend in dispatch.backends_for(op).items():
            backend.make_thunk(dataclasses.replace(small, op=op), torch.device("cpu"))()
    assert dispatch.resolve("deposit_fused", "auto", device="cpu", order=1, grid_shape=(2, 2, 4), capacity=8,
                            batch=3) == "torch"

    seen = []
    real = dispatch.prewarm

    def spy(*a, **k):
        seen.append(k.get("batch"))
        return real(*a, **k)

    dispatch.prewarm = spy
    try:
        shape = (4, 4, 16)
        tpic.EnsembleSimulation(_port_members([(0, 0.0), (1, 0.0)], shape), _config(shape, backend="auto"))
    finally:
        dispatch.prewarm = real
    assert seen == [2]
