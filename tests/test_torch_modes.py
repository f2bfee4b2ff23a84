"""Port parity of the comparison modes and of the generalized matrix scatter:
`deposit_matrix`, `deposit_rhocell` and `gather_matrix` against the
reference for every stagger at orders 1-3; the plain versions of the
`bin_outer_product`, `bin_gather` and `segment_accumulate` kernels against
the reference's Pallas kernels (run as its own tests run them off-TPU, in
interpret mode), on tests/test_kernels.py's shapes; `matrix_scatter_add`
against the reference's, with and without overflow.

On the CPU the ``cuda`` routes run the kernels' plain versions (the wrappers
take them for a CPU tensor); the CUDA kernels are held to those by the
``gpu`` tests of tests/test_torch_gpu.py.

Tolerances:
- one module in float32: rtol 1e-5 / atol 1e-5 (the contractions sum in
  another order than XLA's);
- the plain kernel versions in float32 at tests/test_kernels.py's own
  tolerances (bin_outer_product rtol cap*2e-7, atol 10x that; bin_gather
  2e-5; segment_accumulate 1e-5); in bfloat16 rtol 2e-2 / atol 3e-2 (the
  reference rounds its bfloat16 sums where the port sums in float32);
- matrix_scatter_add: exact for integers, rtol/atol 1e-5 for float32.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as rc  # noqa: E402
import repro_torch.core as tc  # noqa: E402
from repro.kernels.deposition import bin_outer_product as r_bin_outer_product  # noqa: E402
from repro.kernels.gather import bin_gather as r_bin_gather  # noqa: E402
from repro.kernels.scatter_matrix import segment_accumulate as r_segment_accumulate  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.deposition import ops as tdep  # noqa: E402
from repro_torch.kernels.gather import ops as tgat  # noqa: E402
from repro_torch.kernels.scatter_matrix import ops as tseg  # noqa: E402

ORDERS = [1, 2, 3]
GRID = (4, 3, 5)
DEPOSIT_STAGGERS = (tc.NO_STAGGER,) + tc.CURRENT_STAGGER
GATHER_STAGGERS = (tc.NO_STAGGER,) + tc.EB_STAGGERS


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, rtol=1e-5, atol=1e-5):
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=rtol, atol=atol)


def _particles(order, n=300, capacity=16):
    """One numpy draw, binned by both packages (a few live particles left
    unslotted by a small capacity show the slot map's zeros)."""
    rng = np.random.default_rng(10 + order)
    pos = (rng.random((n, 3)) * np.asarray(GRID)).astype(np.float32)
    values = rng.normal(size=n).astype(np.float32)
    alive = rng.random(n) > 0.1
    n_cells = int(np.prod(GRID))
    lr, _ = rc.build_bins(rc.cell_index(jnp.asarray(pos), GRID), jnp.asarray(alive), n_cells=n_cells, capacity=capacity)
    pos_t = torch.from_numpy(pos)
    cells_t = tc.cell_index(pos_t, GRID)
    lt, _ = tc.build_bins(cells_t, torch.from_numpy(alive), n_cells=n_cells, capacity=capacity)
    np.testing.assert_array_equal(lt.slots.numpy(), np.asarray(lr.slots))
    return dict(pos=pos, values=values, lr=lr, lt=lt, pos_t=pos_t, cells_t=cells_t, values_t=torch.from_numpy(values))


@pytest.mark.parametrize("order", ORDERS)
def test_deposit_matrix_and_rhocell_match_reference(order):
    p = _particles(order)
    pos_r, val_r = jnp.asarray(p["pos"]), jnp.asarray(p["values"])
    cells_r = rc.cell_index(pos_r, GRID)
    for stagger in DEPOSIT_STAGGERS:
        want = rc.deposit_matrix(pos_r, val_r, p["lr"], grid_shape=GRID, order=order, stagger=stagger)
        for backend in ("torch", "cuda"):
            got = tc.deposit_matrix(p["pos_t"], p["values_t"], p["lt"], grid_shape=GRID, order=order,
                                    stagger=stagger, backend=backend)
            _close(got, want)
        a_r, b_r = rc.deposition.binned_shape_factors(pos_r, val_r, p["lr"], grid_shape=GRID, order=order,
                                                      stagger=stagger)
        a_t, b_t = tc.binned_shape_factors(p["pos_t"], p["values_t"], p["lt"], grid_shape=GRID, order=order,
                                           stagger=stagger)
        _close(a_t, a_r)
        _close(b_t, b_r)
        got = tc.deposit_rhocell(p["pos_t"], p["values_t"], p["cells_t"], grid_shape=GRID, order=order, stagger=stagger)
        _close(got, rc.deposit_rhocell(pos_r, val_r, cells_r, grid_shape=GRID, order=order, stagger=stagger))


@pytest.mark.parametrize("order", ORDERS)
def test_gather_matrix_matches_reference(order):
    p = _particles(order)
    g = tc.max_guard(order)
    core = np.random.default_rng(20 + order).normal(size=GRID).astype(np.float32)
    padded_r = rc.unfold_guards(jnp.asarray(core), g)
    padded_t = torch.from_numpy(np.asarray(padded_r).copy())
    for stagger in GATHER_STAGGERS:
        want = rc.gather_matrix(jnp.asarray(p["pos"]), padded_r, p["lr"], grid_shape=GRID, order=order, stagger=stagger)
        for backend in ("torch", "cuda"):
            got = tc.gather_matrix(p["pos_t"], padded_t, p["lt"], grid_shape=GRID, order=order, stagger=stagger,
                                   backend=backend)
            _close(got, want)
    assert (p["lt"].particle_slot < 0).any(), "no unslotted particle: the slot map's zeros go untested"


# ---------------------------------------------------------------- kernels, on tests/test_kernels.py's shapes

DEPOSITION_SHAPES = [(8, 8, 2, 4), (64, 16, 2, 4), (100, 8, 3, 4), (128, 32, 4, 16), (37, 8, 5, 16), (1, 8, 2, 4),
                     (512, 128, 4, 16)]
GATHER_SHAPES = [(16, 8, 2, 4), (100, 16, 3, 4), (64, 32, 4, 16), (37, 8, 5, 20)]
SEGMENT_SHAPES = [(16, 8, 32), (256, 16, 512), (100, 8, 64), (33, 4, 1000)]
BF16_TOL = dict(rtol=2e-2, atol=3e-2)


def _normal(seed, shape, dtype):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return torch.from_numpy(x).to(dtype), jnp.asarray(x).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", DEPOSITION_SHAPES, ids=str)
def test_bin_outer_product_plain_matches_pallas(shape, dtype):
    c, cap, m, n = shape
    a_t, a_r = _normal(c * cap + m, (c, cap, m), dtype)
    b_t, b_r = _normal(c * cap + m + 1, (c, cap, n), dtype)
    got = tdep.bin_outer_product(a_t, b_t)
    assert got.dtype == torch.float32
    tol = dict(rtol=cap * 2e-7, atol=cap * 2e-6) if dtype == torch.float32 else BF16_TOL
    _close(got, r_bin_outer_product(a_r, b_r), **tol)


@pytest.mark.parametrize("shape", GATHER_SHAPES, ids=str)
def test_bin_gather_plain_matches_pallas(shape):
    c, cap, m, n = shape
    wx_t, wx_r = _normal(7, (c, cap, m), torch.float32)
    byz_t, byz_r = _normal(8, (c, cap, n), torch.float32)
    g_t, g_r = _normal(9, (c, m, n), torch.float32)
    _close(tgat.bin_gather(wx_t, byz_t, g_t), r_bin_gather(wx_r, byz_r, g_r), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SEGMENT_SHAPES, ids=str)
def test_segment_accumulate_plain_matches_pallas(shape, dtype):
    v, cap, d = shape
    w_t, w_r = _normal(3, (v, cap), dtype)
    u_t, u_r = _normal(4, (v, cap, d), dtype)
    got = tseg.segment_accumulate(w_t, u_t)
    assert got.dtype == dtype
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else BF16_TOL
    _close(got, r_segment_accumulate(w_r, u_r), **tol)


def test_new_wrappers_reject_what_the_kernels_do_not_take_and_launch_nothing_on_cpu():
    kernels.reset_launch_counts()
    a, b = torch.rand(6, 8, 3), torch.rand(6, 8, 4)
    with pytest.raises(TypeError):
        tdep.bin_outer_product(a.double(), b.double())
    with pytest.raises(TypeError):
        tdep.bin_outer_product(a, b.to(torch.bfloat16))
    with pytest.raises(ValueError):
        tdep.bin_outer_product(a, b[:5])
    with pytest.raises(ValueError):
        tgat.bin_gather(a, b, torch.rand(6, 3, 5))
    with pytest.raises(TypeError):
        tgat.bin_gather(a, b, torch.rand(6, 3, 4).double())
    with pytest.raises(ValueError):
        tseg.segment_accumulate(torch.rand(6, 8), torch.rand(6, 7, 4))
    with pytest.raises(TypeError):
        tseg.segment_accumulate(torch.ones(6, 8, dtype=torch.int32), torch.ones(6, 8, 4, dtype=torch.int32))
    tdep.bin_outer_product(a, b)
    tgat.bin_gather(a, b, torch.rand(6, 3, 4))
    tseg.segment_accumulate(torch.rand(6, 8), torch.rand(6, 8, 4))
    assert set(kernels.launch_counts().values()) == {0}


# ---------------------------------------------------------------- matrix_scatter_add


@pytest.mark.parametrize(
    "dtype,capacity",
    [(np.int32, 96), (np.int32, 2), (np.float32, 96), (np.float32, 2)],
    ids=["int-dense", "int-overflow", "f32-dense", "f32-overflow"],
)
def test_matrix_scatter_add_matches_reference(dtype, capacity):
    rng = np.random.default_rng(5)
    n_items, n_bins, dim = 200, 40, 12
    # Zipf-like ids: a few bins overflow a small capacity; -1 drops an item
    idx = np.minimum(rng.zipf(1.5, n_items) - 1, n_bins - 1).astype(np.int32)
    idx[::17] = -1
    if dtype == np.int32:
        upd = rng.integers(-50, 50, (n_items, dim)).astype(np.int32)
        wts = rng.integers(-3, 4, n_items).astype(np.int32)
    else:
        upd = rng.normal(size=(n_items, dim)).astype(np.float32)
        wts = rng.normal(size=n_items).astype(np.float32)
    counts = np.bincount(idx[idx >= 0], minlength=n_bins)
    assert (counts.max() > capacity) == (capacity == 2)
    for weights in (None, wts):
        want = rc.matrix_scatter_add(jnp.asarray(idx), jnp.asarray(upd), n_bins=n_bins, capacity=capacity,
                                     weights=None if weights is None else jnp.asarray(weights))
        kw = {} if weights is None else {"weights": torch.from_numpy(weights)}
        for backend in ("torch", "cuda"):
            got = tc.matrix_scatter_add(torch.from_numpy(idx), torch.from_numpy(upd), n_bins=n_bins,
                                        capacity=capacity, backend=backend, **kw)
            oracle = tc.scatter_add_ref(torch.from_numpy(idx), torch.from_numpy(upd), n_bins=n_bins, **kw)
            if dtype == np.int32:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
                np.testing.assert_array_equal(oracle.numpy(), np.asarray(want))
            else:
                _close(got, want)
                _close(oracle, want)
