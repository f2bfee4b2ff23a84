"""Port parity of the fused deposition and gather, on every finishing route,
at orders 1-3: the routes against the reference's XLA route, the kernels'
plain versions against the reference's Pallas kernels (run as its own tests
run them off-TPU, in interpret mode) and oracles, and everything against
the scatter oracles of both packages.

On the CPU the ``cuda`` and ``cuda_reduced`` routes run the kernels' plain
PyTorch versions (the wrappers take them for a CPU tensor), so these tests
hold the plain versions, the routes' finishing code and the packing to the
reference. The CUDA kernels themselves are held to the plain versions by
the ``gpu`` tests of tests/test_torch_gpu.py.

Tolerance: rtol 1e-5 / atol 1e-5 (one float32 module; the contractions sum
in another order than XLA's), as in tests/test_fused_deposition.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as rc  # noqa: E402
import repro_torch.core as tc  # noqa: E402
from repro.kernels.deposition import ops as rdep  # noqa: E402
from repro.kernels.gather import ops as rgat  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.deposition import ops as tdep  # noqa: E402
from repro_torch.kernels.deposition import ref as tdep_ref  # noqa: E402
from repro_torch.kernels.gather import ops as tgat  # noqa: E402
from repro_torch.kernels.gather import ref as tgat_ref  # noqa: E402

RTOL = ATOL = 1e-5
ORDERS = [1, 2, 3]
GRID = (4, 3, 5)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol)


def _slab(order, grid=GRID, n=300, capacity=16):
    """Identical slabs for both packages, from one numpy draw."""
    rng = np.random.default_rng(order)
    pos = (rng.random((n, 3)) * np.asarray(grid)).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    qw = rng.uniform(0.5, 1.5, n).astype(np.float32)
    n_cells = int(np.prod(grid))
    alive = np.ones(n, bool)
    lr, of = rc.build_bins(rc.cell_index(jnp.asarray(pos), grid), jnp.asarray(alive), n_cells=n_cells, capacity=capacity)
    assert int(of) == 0
    sr, vr = rc.bin_slab_staging(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(qw), lr, grid_shape=grid)
    pos_t, alive_t = torch.from_numpy(pos), torch.from_numpy(alive)
    lt, _ = tc.build_bins(tc.cell_index(pos_t, grid), alive_t, n_cells=n_cells, capacity=capacity)
    st, vt = tc.bin_slab_staging(pos_t, torch.from_numpy(vel), torch.from_numpy(qw), lt, grid_shape=grid)
    return dict(pos=pos, vel=vel, qw=qw, lr=lr, sr=sr, vr=vr, lt=lt, st=st, vt=vt)


def _padded(order, grid=GRID, seed=0):
    g = tc.max_guard(order)
    core = np.random.default_rng(100 + seed).normal(size=(6, *grid)).astype(np.float32)
    return core, np.stack([np.asarray(rc.unfold_guards(jnp.asarray(c), g)) for c in core])


# ---------------------------------------------------------------- deposition


@pytest.mark.parametrize("order", ORDERS)
def test_fused_deposition_routes_match_reference(order):
    s = _slab(order)
    d_r, v_r = s["sr"].d, s["vr"]
    d_t, v_t = s["st"].d, s["vt"]
    # the reference's Pallas routes are pinned to its XLA route by its own
    # tests; the kernels themselves are compared below
    ref = rc.fused_deposit_grids(d_r, v_r, grid_shape=GRID, order=order, backend="xla")
    for backend in ("torch", "cuda", "cuda_reduced"):
        out = tc.fused_deposit_grids(d_t, v_t, grid_shape=GRID, order=order, backend=backend)
        for comp in range(3):
            _close(out[comp], ref[comp])


@pytest.mark.parametrize("order", ORDERS)
def test_fused_deposition_matches_scatter_oracles(order):
    s = _slab(order)
    pos_t, vel_t, qw_t = (torch.from_numpy(s[k]) for k in ("pos", "vel", "qw"))
    fused = tc.deposit_current_matrix_fused(pos_t, vel_t, qw_t, s["lt"], grid_shape=GRID, order=order,
                                            backend="cuda_reduced")
    for comp in range(3):
        values = s["qw"] * s["vel"][:, comp]
        stagger = tc.CURRENT_STAGGER[comp]
        mine = tc.deposit_scatter(pos_t, torch.from_numpy(values), grid_shape=GRID, order=order, stagger=stagger)
        theirs = rc.deposit_scatter(jnp.asarray(s["pos"]), jnp.asarray(values), grid_shape=GRID, order=order,
                                    stagger=stagger)
        _close(mine, theirs)
        _close(fused[comp], mine)


@pytest.mark.parametrize("order", ORDERS)
def test_deposition_plain_versions_match_pallas_kernels(order):
    """The kernels' plain versions against the reference's Pallas kernels
    (interpret mode) and its oracles, on identical slabs."""
    s = _slab(order)
    d_r, v_r, d_t, v_t = s["sr"].d, s["vr"], s["st"].d, s["vt"]
    g = tc.max_guard(order)
    packed = tdep.fused_bin_deposit(d_t, v_t, order=order)
    _close(packed, rdep.fused_bin_deposit(d_r, v_r, order=order))
    _close(packed, rdep.fused_bin_deposit_ref(d_r, v_r, order=order))
    reduced = tdep.fused_bin_deposit_reduced(d_t, v_t, order=order, grid_shape=GRID, guard=g)
    _close(reduced, rdep.fused_bin_deposit_reduced(d_r, v_r, order=order, grid_shape=GRID, guard=g))
    _close(reduced, rdep.fused_bin_deposit_reduced_ref(d_r, v_r, order=order, grid_shape=GRID, guard=g))


# ---------------------------------------------------------------- gather


@pytest.mark.parametrize("order", ORDERS)
def test_fused_gather_routes_match_reference(order):
    s = _slab(order)
    _, padded = _padded(order)
    fields_r = tuple(jnp.asarray(f) for f in padded)
    ref = rc.fused_gather_bins(s["sr"].d, fields_r, grid_shape=GRID, order=order, backend="xla")
    # gap slots alias particle 0 and are never read back; the true-support and
    # unified-window routes may disagree there, so only occupied slots count
    valid = _np(s["st"].valid)
    for backend in ("torch", "cuda"):
        out = tc.fused_gather_bins(s["st"].d, torch.from_numpy(padded), grid_shape=GRID, order=order, backend=backend)
        _close(_np(out)[valid], _np(ref)[valid])


@pytest.mark.parametrize("order", ORDERS)
def test_gather_plain_version_matches_pallas_kernel(order):
    s = _slab(order)
    _, padded = _padded(order)
    g = tc.max_guard(order)
    t, base = rc.unified_support(order)
    packed_r = jnp.stack(
        [rc.gather.extract_neighborhoods(jnp.asarray(f), GRID, taps=(t, t, t), bases=(base,) * 3, guard=g)
         .reshape(-1, t, t * t) for f in padded],
        axis=1,
    )
    packed_t = tc.pack_neighborhoods(torch.from_numpy(padded), grid_shape=GRID, order=order, guard=g)
    np.testing.assert_array_equal(_np(packed_t), _np(packed_r))
    out = tgat.fused_bin_gather(s["st"].d, torch.from_numpy(padded), grid_shape=GRID, order=order, guard=g)
    _close(out, rgat.fused_bin_gather(s["sr"].d, packed_r, order=order))
    _close(out, rgat.fused_bin_gather_ref(s["sr"].d, packed_r, order=order))
    _close(tgat_ref.fused_bin_gather_ref(s["st"].d, packed_t, order=order), out)


@pytest.mark.parametrize("order", ORDERS)
def test_gather_fields_fused_matches_reference_and_oracle(order):
    s = _slab(order)
    core, padded = _padded(order)
    e_r, b_r = rc.gather_fields_fused(s["sr"], tuple(jnp.asarray(f) for f in padded), s["lr"], grid_shape=GRID,
                                      order=order, backend="xla")
    e_t, b_t = tc.gather_fields_fused(s["st"], torch.from_numpy(padded), s["lt"], grid_shape=GRID, order=order,
                                      backend="cuda")
    _close(e_t, e_r)
    _close(b_t, b_r)
    pos_t = torch.from_numpy(s["pos"])
    for comp, stagger in enumerate(tc.EB_STAGGERS):
        oracle = tc.gather_scatter(pos_t, torch.from_numpy(padded[comp]), order=order, stagger=stagger)
        _close(oracle, rc.gather_scatter(jnp.asarray(s["pos"]), jnp.asarray(padded[comp]), order=order,
                                         stagger=stagger))
        _close((e_t if comp < 3 else b_t)[:, comp % 3], oracle)


# ---------------------------------------------------------------- wrappers


def test_wrappers_reject_what_the_kernels_do_not_take():
    d = torch.rand(60, 8, 3)
    v = torch.rand(60, 8, 3)
    with pytest.raises(TypeError):
        tdep.fused_bin_deposit(d.double(), v.double(), order=2)
    with pytest.raises(ValueError):
        tdep.fused_bin_deposit(d, v[:, :4], order=2)
    with pytest.raises(ValueError):
        tdep.fused_bin_deposit(d, v, order=4)
    with pytest.raises(ValueError):
        tdep.fused_bin_deposit_reduced(d, v, order=2, grid_shape=(4, 4, 4), guard=2)
    with pytest.raises(ValueError):
        tdep.fused_bin_deposit_reduced(d, v, order=2, grid_shape=GRID, guard=1)
    padded = torch.rand(6, 8, 7, 9)
    with pytest.raises(ValueError):
        tgat.fused_bin_gather(d, padded, grid_shape=GRID, order=2, guard=1)
    with pytest.raises(ValueError):
        tgat.fused_bin_gather(d, padded[:5], grid_shape=GRID, order=2, guard=2)
    with pytest.raises(TypeError):
        tgat.fused_bin_gather(d, padded.double(), grid_shape=GRID, order=2, guard=2)


def test_cpu_wrappers_run_plain_versions_and_launch_nothing():
    kernels.reset_launch_counts()
    s = _slab(2)
    d, v = s["st"].d, s["vt"]
    assert torch.equal(tdep.fused_bin_deposit(d, v, order=2), tdep_ref.fused_bin_deposit_ref(d, v, order=2))
    tdep.fused_bin_deposit_reduced(d, v, order=2, grid_shape=GRID, guard=2)
    _, padded = _padded(2)
    tgat.fused_bin_gather(d, torch.from_numpy(padded), grid_shape=GRID, order=2, guard=2)
    assert set(kernels.launch_counts().values()) == {0}
