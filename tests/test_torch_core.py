"""Port parity of the core building blocks: shape functions, binning, the
rhocell reductions, guard fold/unfold, the GPMA update, the re-sort policy
and the kernel dispatcher.

Every input is made with numpy from a seed and goes to both packages.
Integers (slots, particle slots, counters, reasons) must match exactly;
floats at rtol 1e-5 / atol 1e-5 (one module, float32, operations in the
reference's order — most agree to the bit, the slack covers reductions
whose summation order differs between XLA and PyTorch).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as rc  # noqa: E402
import repro_torch.core as tc  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402

RTOL = ATOL = 1e-5
ORDERS = [1, 2, 3]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(a)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _particles(n, grid, seed, dead_frac=0.0):
    rng = np.random.default_rng(seed)
    pos = (rng.random((n, 3)) * np.asarray(grid)).astype(np.float32)
    alive = rng.random(n) >= dead_frac
    return pos, alive


# ---------------------------------------------------------------- shape functions


@pytest.mark.parametrize("order", ORDERS)
def test_support_tables_match(order):
    for s in (False, True):
        assert tc.support(order, s) == rc.support(order, s)
    assert tc.unified_support(order) == rc.unified_support(order)
    assert tc.max_guard(order) == rc.max_guard(order)
    assert tc.unified_support(order) == {1: (3, -1), 2: (4, -1), 3: (5, -2)}[order]
    assert tc.max_guard(order) == {1: 1, 2: 2, 3: 2}[order]


@pytest.mark.parametrize("order", ORDERS)
def test_bspline_and_weights_match(order):
    u = np.linspace(-2.6, 2.6, 417).astype(np.float32)
    np.testing.assert_allclose(_np(tc.bspline(order, _t(u))), _np(rc.bspline(order, _j(u))), rtol=RTOL, atol=ATOL)
    d = np.random.default_rng(order).random((7, 11)).astype(np.float32)
    for s in (False, True):
        np.testing.assert_allclose(
            _np(tc.shape_weights(_t(d), order, s)), _np(rc.shape_weights(_j(d), order, s)), rtol=RTOL, atol=ATOL
        )
    d3 = np.random.default_rng(10 + order).random((5, 4, 3)).astype(np.float32)
    wt, wr = tc.packed_axis_weights(_t(d3), order), rc.packed_axis_weights(_j(d3), order)
    assert set(wt) == set(wr)
    for key in wt:
        np.testing.assert_allclose(_np(wt[key]), _np(wr[key]), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("order", ORDERS)
def test_weights_partition_of_unity(order):
    d = torch.linspace(0.0, 0.999, 101)
    for s in (False, True):
        np.testing.assert_allclose(tc.shape_weights(d, order, s).sum(-1).numpy(), 1.0, rtol=0, atol=1e-6)


# ---------------------------------------------------------------- binning


def test_cell_index_and_coords_match():
    grid = (5, 3, 4)
    pos, _ = _particles(300, grid, 0)
    # positions on and just past the box edges exercise the clip
    pos[:4] = [[5.0, 0.0, 4.0], [-1e-7, 3.0, 0.0], [4.9999995, 2.9999998, 3.9999998], [0.0, 0.0, 0.0]]
    np.testing.assert_array_equal(_np(tc.cell_index(_t(pos), grid)), _np(rc.cell_index(_j(pos), grid)))
    np.testing.assert_array_equal(_np(tc.cell_coords(60, grid)), _np(rc.cell_coords(60, grid)))


@pytest.mark.parametrize("capacity", [3, 8])
def test_build_bins_exact(capacity):
    grid = (4, 3, 5)
    n_cells = 60
    pos, alive = _particles(400, grid, capacity, dead_frac=0.1)
    cells = rc.cell_index(_j(pos), grid)
    lr, of_r = rc.build_bins(cells, _j(alive), n_cells=n_cells, capacity=capacity)
    lt, of_t = tc.build_bins(tc.cell_index(_t(pos), grid), _t(alive), n_cells=n_cells, capacity=capacity)
    np.testing.assert_array_equal(_np(lt.slots), _np(lr.slots))
    np.testing.assert_array_equal(_np(lt.particle_slot), _np(lr.particle_slot))
    assert int(of_t) == int(of_r)
    if capacity == 3:
        assert int(of_t) > 0, "small capacity must overflow"


def test_sort_permutation_and_permute_match():
    grid = (4, 4, 4)
    pos, alive = _particles(200, grid, 3, dead_frac=0.2)
    perm_r = rc.sort_permutation(rc.cell_index(_j(pos), grid), _j(alive))
    perm_t = tc.sort_permutation(tc.cell_index(_t(pos), grid), _t(alive))
    np.testing.assert_array_equal(_np(perm_t), _np(perm_r))
    assert tc.choose_capacity(8) == rc.choose_capacity(8) == 16


def test_slab_staging_matches():
    grid = (4, 3, 5)
    pos, alive = _particles(300, grid, 5, dead_frac=0.1)
    rng = np.random.default_rng(6)
    vel = rng.normal(size=(300, 3)).astype(np.float32)
    qw = rng.random(300).astype(np.float32)
    lr, _ = rc.build_bins(rc.cell_index(_j(pos), grid), _j(alive), n_cells=60, capacity=8)
    lt, _ = tc.build_bins(tc.cell_index(_t(pos), grid), _t(alive), n_cells=60, capacity=8)
    sr, vr = rc.bin_slab_staging(_j(pos), _j(vel), _j(qw), lr, grid_shape=grid)
    st, vt = tc.bin_slab_staging(_t(pos), _t(vel), _t(qw), lt, grid_shape=grid)
    np.testing.assert_array_equal(_np(st.d), _np(sr.d))
    np.testing.assert_array_equal(_np(st.valid), _np(sr.valid))
    np.testing.assert_array_equal(_np(vt), _np(vr))
    np.testing.assert_array_equal(_np(tc.build_bin_slab(_t(pos), lt, grid_shape=grid).d), _np(st.d))
    np.testing.assert_array_equal(_np(tc.bin_slab_values(_t(vel), _t(qw), lt, st)), _np(vt))
    d_t, v_t = tc.fused_bin_slab(_t(pos), _t(vel), _t(qw), lt, grid_shape=grid)
    d_r, v_r = rc.fused_bin_slab(_j(pos), _j(vel), _j(qw), lr, grid_shape=grid)
    np.testing.assert_array_equal(_np(d_t), _np(d_r))
    np.testing.assert_array_equal(_np(v_t), _np(v_r))


# ---------------------------------------------------------------- rhocell


@pytest.mark.parametrize("order", ORDERS)
def test_rhocell_reductions_match(order):
    grid = (4, 5, 3)
    t, base = tc.unified_support(order)
    g = tc.max_guard(order)
    rho = np.random.default_rng(order).normal(size=(60, t, t, t)).astype(np.float32)
    bases = (base, base, base)
    direct = _np(tc.reduce_rhocell(_t(rho), grid, bases, g))
    np.testing.assert_allclose(direct, _np(rc.reduce_rhocell(_j(rho), grid, bases, g)), rtol=RTOL, atol=ATOL)
    sep = _np(tc.reduce_rhocell_separable(_t(rho), grid, bases, g))
    np.testing.assert_allclose(sep, _np(rc.reduce_rhocell_separable(_j(rho), grid, bases, g)), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(sep, direct, rtol=RTOL, atol=ATOL)
    acc = np.random.default_rng(7).normal(size=(4, 5, 3 + 2 * g, t, t)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tc.reduce_rhocell_tail(_t(acc), grid, (base, base), g)),
        _np(rc.reduce_rhocell_tail(_j(acc), grid, (base, base), g)), rtol=RTOL, atol=ATOL,
    )


@pytest.mark.parametrize("guard", [1, 2])
def test_fold_unfold_guards_match(guard):
    padded = np.random.default_rng(guard).normal(size=(6 + 2 * guard, 4 + 2 * guard, 5 + 2 * guard)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tc.fold_guards(_t(padded), guard)), _np(rc.fold_guards(_j(padded), guard)), rtol=RTOL, atol=ATOL
    )
    core = padded[: 6, : 4, : 5].copy()
    np.testing.assert_array_equal(_np(tc.unfold_guards(_t(core), guard)), _np(rc.unfold_guards(_j(core), guard)))
    stack = np.stack([core, 2 * core])
    both = _np(tc.unfold_guards(_t(stack), guard, dims=(1, 2, 3)))
    np.testing.assert_array_equal(both[1], _np(rc.unfold_guards(_j(2 * core), guard)))


# ---------------------------------------------------------------- GPMA


def _gpma_case(seed, *, n=500, grid=(4, 4, 4), cap=16, step=0.6, dead_frac=0.0, kill_frac=0.0):
    rng = np.random.default_rng(seed)
    pos = (rng.random((n, 3)) * np.asarray(grid)).astype(np.float32)
    alive = rng.random(n) >= dead_frac
    new_pos = np.mod(pos + step * rng.normal(size=(n, 3)), np.asarray(grid)).astype(np.float32)
    new_alive = alive & (rng.random(n) >= kill_frac)
    return pos, alive, new_pos, new_alive, grid, cap


@pytest.mark.parametrize(
    "case",
    [
        dict(seed=0),                                   # plain churn
        dict(seed=1, cap=10, step=1.5),                 # overflow on insert
        dict(seed=2, dead_frac=0.15, kill_frac=0.1),    # dead and dying particles
        dict(seed=3, cap=9, dead_frac=0.05, step=0.9),  # all of it, stale unslotted entries
    ],
)
def test_gpma_update_exact(case):
    pos, alive, new_pos, new_alive, grid, cap = _gpma_case(**case)
    n_cells = int(np.prod(grid))
    lr, _ = rc.build_bins(rc.cell_index(_j(pos), grid), _j(alive), n_cells=n_cells, capacity=cap)
    lt, _ = tc.build_bins(tc.cell_index(_t(pos), grid), _t(alive), n_cells=n_cells, capacity=cap)
    for _ in range(2):  # a second update starts from unslotted overflow stragglers
        lr, sr = rc.gpma_update(lr, rc.cell_index(_j(new_pos), grid), _j(new_alive))
        lt, st = tc.gpma_update(lt, tc.cell_index(_t(new_pos), grid), _t(new_alive))
        np.testing.assert_array_equal(_np(lt.slots), _np(lr.slots))
        np.testing.assert_array_equal(_np(lt.particle_slot), _np(lr.particle_slot))
        for name in ("n_moved", "n_overflow", "n_empty", "n_alive"):
            assert int(getattr(st, name)) == int(getattr(sr, name)), name
        new_pos = np.mod(new_pos + 0.3, np.asarray(grid)).astype(np.float32)
    if case["seed"] == 1:
        assert int(st.n_overflow) > 0


# ---------------------------------------------------------------- policy


def test_policy_update_matches_reference():
    cfg_r = rc.SortPolicyConfig(sort_interval=12, min_sort_interval=3, sort_trigger_full_ratio=0.7)
    cfg_t = tc.SortPolicyConfig(sort_interval=12, min_sort_interval=3, sort_trigger_full_ratio=0.7)
    rng = np.random.default_rng(0)
    sr, st = rc.policy_init(), tc.policy_init()
    n_slots = 1000
    seen = set()
    for step in range(60):
        n_moved = int(rng.integers(0, 400))
        n_empty = int(rng.integers(50, 950))
        kw_r = dict(n_moved=jnp.int32(n_moved), n_alive=jnp.int32(500), n_empty=jnp.int32(n_empty), n_slots=n_slots)
        kw_t = dict(n_moved=torch.tensor(n_moved), n_alive=torch.tensor(500), n_empty=torch.tensor(n_empty), n_slots=n_slots)
        do_r, reason_r, rec_r = rc.policy_update(sr, cfg_r, **kw_r)
        do_t, reason_t, rec_t = tc.policy_update(st, cfg_t, **kw_t)
        assert bool(do_t) == bool(do_r) and int(reason_t) == int(reason_r), step
        seen.add(int(reason_t))
        for name in ("steps_since_sort", "rebuilds_since_sort"):
            assert int(getattr(rec_t, name)) == int(getattr(rec_r, name))
        for name in ("baseline_proxy", "proxy_ema"):
            np.testing.assert_allclose(float(getattr(rec_t, name)), float(getattr(rec_r, name)), rtol=1e-6)
        sr, st = (rc.policy_reset(), tc.policy_reset()) if bool(do_r) else (rec_r, rec_t)
    assert len(seen) >= 3, f"sequence exercised too few triggers: {seen}"
    assert tc.REASON_NAMES == rc.REASON_NAMES


# ---------------------------------------------------------------- dispatch


def test_dispatch_resolution(monkeypatch):
    """Forced names in both vocabularies, ``auto`` on the CPU (``torch``,
    untimed) and, on a CUDA key left unmeasured, the priority order that a
    capture or a demotion falls back to."""
    monkeypatch.setattr(dispatch, "platform", lambda device: torch.device(device).type)
    dispatch.clear_memo()
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    g = (4, 4, 4)
    kw = dict(order=1, capacity=4)
    assert dispatch.resolve("deposit_fused", "auto", device=cpu, grid_shape=g, **kw) == "torch"
    assert dispatch.resolve("gather_fused", "auto", device=cpu, grid_shape=g, **kw) == "torch"
    untimed = dict(kw, allow_benchmark=False)
    assert dispatch.resolve("deposit_fused", "auto", device=cuda, grid_shape=g, **untimed) == "cuda_reduced"
    assert dispatch.resolve("deposit_fused", "auto", device=cuda, **untimed) == "cuda"
    assert dispatch.resolve("gather_fused", "auto", device=cuda, grid_shape=g, **untimed) == "cuda"
    assert dispatch.resolve("gather_fused", "cuda_reduced", device=cuda, grid_shape=g, **kw) == "cuda"
    assert dispatch.resolve("deposit_fused", "pallas_reduced", device=cpu, grid_shape=g, **kw) == "cuda_reduced"
    assert dispatch.resolve("deposit_fused", "xla", device=cuda, grid_shape=g, **kw) == "torch"
    assert dispatch.counters["benchmark"] == 0
    # the demotion ladder of the reference, in the port's names
    assert dispatch.demote("auto", device=cuda, grid_shape=g, **kw) == "cuda"
    assert dispatch.demote("cuda", device=cuda, grid_shape=g, **kw) == "torch"
    assert dispatch.demote("torch", device=cuda, grid_shape=g, **kw) is None
    dispatch.clear_memo()
    with pytest.raises(ValueError):
        dispatch.canonical("triton")
    assert [dispatch.canonical(n) for n in ("xla", "pallas", "pallas_reduced")] == ["torch", "cuda", "cuda_reduced"]


# ---------------------------------------------------------------- deposit_current


@pytest.mark.parametrize("method", ["matrix", "matrix_unfused", "scatter", "rhocell"])
def test_deposit_current_matches_reference(method):
    """`deposit_current`'s four methods, folded and padded, against the
    reference's on the same particles and bins."""
    grid, order = (4, 3, 5), 2
    pos, alive = _particles(240, grid, 11, dead_frac=0.1)
    rng = np.random.default_rng(12)
    vel = rng.normal(scale=0.3, size=(240, 3)).astype(np.float32)
    qw = (rng.random(240) * alive).astype(np.float32)
    cells_r, cells_t = rc.cell_index(_j(pos), grid), tc.cell_index(_t(pos), grid)
    lr, _ = rc.build_bins(cells_r, _j(alive), n_cells=60, capacity=16)
    lt, _ = tc.build_bins(cells_t, _t(alive), n_cells=60, capacity=16)
    kw_r = dict(layout=lr, cell_ids=cells_r) | ({"backend": "xla"} if method.startswith("matrix") else {})
    kw_t = dict(layout=lt, cell_ids=cells_t) | ({"backend": "torch"} if method.startswith("matrix") else {})
    for fold in (True, False):
        got = tc.deposit_current(_t(pos), _t(vel), _t(qw), grid_shape=grid, order=order, method=method, fold=fold,
                                 **kw_t)
        want = rc.deposit_current(_j(pos), _j(vel), _j(qw), grid_shape=grid, order=order, method=method, fold=fold,
                                  **kw_r)
        assert len(got) == 3
        for a, b in zip(got, want):
            assert a.shape == b.shape
            np.testing.assert_allclose(_np(a), _np(b), rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="unknown method"):
        tc.deposit_current(_t(pos), _t(vel), _t(qw), grid_shape=grid, order=order, method="nope")


def test_canonical_flops_match_reference():
    assert tc.CANONICAL_FLOPS_PER_PARTICLE == rc.shape_functions.CANONICAL_FLOPS_PER_PARTICLE
