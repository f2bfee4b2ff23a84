"""The port's CUDA kernels on the card: each held to its plain PyTorch
version, and fed NaN and Inf; the windowed simulation run through every
backend and mode; the window captured as a CUDA graph against the same
window run eagerly; the host-driven loop against the captured window, and a
run saved, loaded and continued against the same run uninterrupted; the
health sentinel and a fault's rollback inside the captured window; an
ensemble bucket captured as one graph against its members' solo runs, the
simulation service's window cache, and the distributed driver's captured
window (a 2x2 mesh on the card) against its eager one.

These tests need a CUDA device and skip without one (the kernels have no
CPU mode). They import neither JAX nor `repro`, so they run where only the
port is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: the packed deposition against its plain version, exact; a
kernel against its plain version, rtol 1e-5 / atol 1e-5 (the
kernels sum over the slots in order in registers, the plain versions through
cuBLAS batched products), in float32 and in bfloat16 (the kernels widen
bfloat16 operands to float32, as the plain versions do); the unfused
deposition's two copy routes and repeated launches, exact; backends and modes
after 8 windowed steps, 1e-4 of the field's largest magnitude (those sums
compound through the field solve); `matrix_scatter_add` against a plain
scatter-add, 1e-5 of the output's magnitude (both add the overflow items
with float atomics, in orders that change from run to run); the captured
window against the eager one, exact (the same kernels on the same inputs), the
distributed one's too;
the host-driven loop against the captured window and a resumed run against
an uninterrupted one, exact; the sentinel on against off, and a run that
rolled back from an injected fault against the clean run, exact; an
ensemble's members against their solo runs, exact (each member's kernels
run at its own shapes), a mild sibling re-binned at a grown capacity
included.

Where a test holds an ``auto`` run's launch counts, it holds them to the
backends the dispatcher's autotune resolved (into a cache file of the
test's own).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.api import (  # noqa: E402
    EnsembleSpec,
    SortPolicyConfig,
    load_simulation,
    make_ensemble,
    make_simulation,
    scenario,
)
from repro_torch.core import (  # noqa: E402
    CURRENT_STAGGER,
    EB_STAGGERS,
    NO_STAGGER,
    bin_slab_staging,
    build_bins,
    cell_index,
    matrix_scatter_add,
    max_guard,
    scatter_add_ref,
    support,
)
from repro_torch.kernels.deposition import ops as dep  # noqa: E402
from repro_torch.kernels.deposition import ref as dep_ref  # noqa: E402
from repro_torch.kernels.gather import ops as gat  # noqa: E402
from repro_torch.kernels.gather import ref as gat_ref  # noqa: E402
from repro_torch.kernels.scatter_matrix import ops as seg  # noqa: E402
from repro_torch.kernels.scatter_matrix import ref as seg_ref  # noqa: E402

ORDERS = [1, 2, 3]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture(autouse=True)
def _autotune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv(dispatch.CACHE_ENV, str(tmp_path / "autotune.json"))


KERNEL_OF = {("deposit_fused", "cuda_reduced"): "fused_bin_deposit_reduced", ("deposit_fused", "cuda"): "fused_bin_deposit",
             ("gather_fused", "cuda"): "fused_bin_gather"}


def _want_launches(sim, n):
    """The fused kernels' launches in n steps under the backends the
    dispatcher resolves for the driver's step: every op of the step must
    resolve to a kernel."""
    c = sim.config
    chosen = dispatch.prewarm(dispatch.ops_for_modes(c.deposition, c.gather), device=sim.device, order=c.order,
                              grid_shape=c.grid.shape, capacity=c.capacity, dtype=sim.state.particles.pos.dtype,
                              requested=c.backend)
    assert chosen and all(kv in KERNEL_OF for kv in chosen.items()), f"resolved to no kernel: {chosen}"
    return {KERNEL_OF[kv]: n for kv in chosen.items()}


def _slab(grid, n, capacity, seed, device):
    rng = np.random.default_rng(seed)
    pos = torch.from_numpy((rng.random((n, 3)) * np.asarray(grid)).astype(np.float32)).to(device)
    vel = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(device)
    qw = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)).to(device)
    alive = torch.ones(n, dtype=torch.bool, device=device)
    layout, overflow = build_bins(cell_index(pos, grid), alive, n_cells=int(np.prod(grid)), capacity=capacity)
    assert int(overflow) == 0
    slab, val = bin_slab_staging(pos, vel, qw, layout, grid_shape=grid)
    return slab.d, val.contiguous()


def _close(a, b, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(a.float().cpu().numpy(), b.float().cpu().numpy(), rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("order", ORDERS)
def test_kernels_match_plain_versions(order, cuda):
    grid, g = (6, 5, 7), max_guard(order)
    d, val = _slab(grid, 1500, 64, order, cuda)
    before = kernels.launch_counts()
    _close(dep.fused_bin_deposit(d, val, order=order), dep_ref.fused_bin_deposit_ref(d, val, order=order))
    _close(
        dep.fused_bin_deposit_reduced(d, val, order=order, grid_shape=grid, guard=g),
        dep_ref.fused_bin_deposit_reduced_ref(d, val, order=order, grid_shape=grid, guard=g),
    )
    padded = torch.randn(6, *(n + 2 * g for n in grid), device=cuda)
    _close(
        gat.fused_bin_gather(d, padded, grid_shape=grid, order=order, guard=g),
        gat_ref.fused_gather_ref(d, padded, grid_shape=grid, order=order, guard=g),
    )
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert all(after[k] == before[k] + 1 for k in ("fused_bin_deposit", "fused_bin_deposit_reduced", "fused_bin_gather"))


@pytest.mark.gpu
@pytest.mark.parametrize("order", ORDERS)
def test_unfused_kernels_match_plain_versions(order, cuda):
    """bin_outer_product at the M x N of every current stagger and
    bin_gather at every field stagger, on a cell count no block size
    divides; bin_outer_product and segment_accumulate in both types."""
    gen = torch.Generator(device=cuda).manual_seed(order)
    before = kernels.launch_counts()
    for stagger in (NO_STAGGER,) + CURRENT_STAGGER:
        (tx, ty, tz) = (support(order, st)[0] for st in stagger)
        a = torch.randn((203, 32, tx), generator=gen, device=cuda)
        b = torch.randn((203, 32, ty * tz), generator=gen, device=cuda)
        for dtype in (torch.float32, torch.bfloat16):
            ad, bd = a.to(dtype), b.to(dtype)
            _close(dep.bin_outer_product(ad, bd), dep_ref.bin_outer_product_ref(ad, bd))
    for stagger in (NO_STAGGER,) + EB_STAGGERS:
        (tx, ty, tz) = (support(order, st)[0] for st in stagger)
        wx = torch.rand((203, 40, tx), generator=gen, device=cuda)
        byz = torch.rand((203, 40, ty * tz), generator=gen, device=cuda)
        g = torch.randn((203, tx, ty * tz), generator=gen, device=cuda)
        _close(gat.bin_gather(wx, byz, g), gat_ref.bin_gather_ref(wx, byz, g))
    for v, cap, d in ((203, 2, 333), (57, 16, 2100)):
        for dtype in (torch.float32, torch.bfloat16):
            w = torch.randn((v, cap), generator=gen, device=cuda).to(dtype)
            u = torch.randn((v, cap, d), generator=gen, device=cuda).to(dtype)
            got, want = seg.segment_accumulate(w, u), seg_ref.segment_accumulate_ref(w, u)
            assert got.dtype == dtype
            assert torch.equal(got, want), "the kernel and its plain version sum in one order"
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["bin_outer_product"] - before["bin_outer_product"] == 8
    assert after["bin_gather"] - before["bin_gather"] == 7
    assert after["segment_accumulate"] - before["segment_accumulate"] == 4


@pytest.mark.gpu
def test_matrix_scatter_add_on_the_card(cuda):
    gen = np.random.default_rng(1)
    idx = torch.from_numpy(np.minimum(gen.zipf(1.5, 3000) - 1, 499)).to(cuda)
    upd = torch.from_numpy(gen.normal(size=(3000, 96)).astype(np.float32)).to(cuda)
    w = torch.from_numpy(gen.normal(size=3000).astype(np.float32)).to(cuda)
    kernels.reset_launch_counts()
    dispatch.reset_counters()
    got = matrix_scatter_add(idx, upd, n_bins=500, capacity=8, weights=w)  # auto: the kernel, untimed
    assert kernels.launch_counts()["segment_accumulate"] == 1
    assert dispatch.counters["benchmark"] == 0 and dispatch.counters["plain_on_card"] == 0
    # both add a bin's overflow (up to ~1600 items) with float atomics, in
    # orders that change from run to run: 1e-5 of the output's magnitude
    want = scatter_add_ref(idx, upd, n_bins=500, weights=w)
    _close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize(
    "kw",
    [dict(backend="cuda_reduced"), dict(backend="cuda"), dict(backend="torch"),
     dict(deposition="matrix_unfused", gather="matrix_unfused"), dict(deposition="scatter", gather="scatter"),
     dict(deposition="rhocell", gather="scatter")],
    ids=["cuda_reduced", "cuda", "torch", "matrix_unfused", "scatter", "rhocell"],
)
def test_windowed_backends_agree(kw, cuda):
    """Every backend and comparison mode, captured and replayed, against
    the default path; each bin kernel launches once per step (and once in
    each capture's warm-up step)."""
    fields = {}
    for label, extra in (("default", {}), ("other", kw)):
        kernels.reset_launch_counts()
        sim = make_simulation(scenario("uniform", grid=(16, 16, 16), order=2, steps=8, window=4, **extra))
        assert sim.device.type == "cuda" and sim.use_graphs
        sim.run()
        assert sim.host_reads == sim.windows
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        n = 8 + sim.graph_captures
        want = _want_launches(sim, n) if label == "default" else None
        if want is None:
            want = {
                "cuda_reduced": {"fused_bin_deposit_reduced": n, "fused_bin_gather": n},
                "cuda": {"fused_bin_deposit": n, "fused_bin_gather": n},
                "matrix_unfused": {"bin_outer_product": 3 * n, "bin_gather": 6 * n},
            }.get(kw.get("backend") or kw.get("deposition"), {})
        assert counts == want
        fields[label] = [f.cpu().numpy() for f in sim.state.fields.all()]
    for a, b in zip(fields["other"], fields["default"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * max(np.abs(b).max(), 1e-30))


@pytest.mark.gpu
def test_captured_window_matches_eager_window(cuda):
    """20 steps in windows of 10 with a sort every few steps and a capacity
    growth (a hot plasma in bins of 8): replays of the captured step give
    the eager window's state exactly, with one host read a window (two more
    at the growth) where the eager window reads every decision."""
    spec = scenario("uniform", grid=(6, 6, 6), order=1, capacity=8, u_thermal=0.4, backend="cuda_reduced",
                    policy=SortPolicyConfig(sort_interval=7, min_sort_interval=3))
    sims = {}
    for graphs in (True, False):
        sim = make_simulation(spec)
        sim.use_graphs = graphs
        kernels.reset_launch_counts()
        sim.run(20, window=10, diagnostics_every=1)
        sims[graphs] = (sim, kernels.launch_counts())
    (g, g_counts), (e, e_counts) = sims[True], sims[False]
    assert g.growths["capacity"] >= 1 and g.sorts >= 1
    assert (g.sorts, g.rebuilds, g.growths, g.halts) == (e.sorts, e.rebuilds, e.growths, e.halts)
    assert g.history == e.history
    assert g.host_reads == g.windows + 2 * g.growths["capacity"]
    assert e.host_reads > g.host_reads
    assert g.graph_captures == 1 + g.growths["capacity"]
    for name in ("fused_bin_deposit_reduced", "fused_bin_gather"):
        assert e_counts[name] == 20 and g_counts[name] == 20 + g.graph_captures
    sg, se = g.state, e.state
    assert sg.step == se.step == 20
    for part in ("fields", "particles", "layout", "slab"):
        a, b = getattr(sg, part), getattr(se, part)
        for f in dataclasses.fields(a):
            assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f"{part}.{f.name}"
    for f in dataclasses.fields(g.policy_state):
        assert torch.equal(getattr(g.policy_state, f.name), getattr(e.policy_state, f.name)), f.name


@pytest.mark.gpu
def test_distributed_captured_window_matches_eager_window(cuda):
    """A 2x2 mesh held on the card: 20 steps in windows of 10 with a sort
    every few steps and a capacity growth (a hot plasma in bins of 8).
    Replays of the captured window step (every shard's kernels, the
    exchanges, the IF nodes) give the eager window's state exactly, with
    one host read a window and one more at the growth; each kernel launches
    once a shard a step."""
    spec = scenario("uniform", grid=(8, 8, 8), order=1, capacity=8, u_thermal=0.4, backend="cuda_reduced", mesh="2x2",
                    policy=SortPolicyConfig(sort_interval=7, min_sort_interval=3))
    sims = {}
    for graphs in (True, False):
        sim = make_simulation(spec)
        sim.use_graphs = graphs
        kernels.reset_launch_counts()
        sim.run(20, window=10, diagnostics_every=1)
        sims[graphs] = (sim, kernels.launch_counts())
    (g, g_counts), (e, e_counts) = sims[True], sims[False]
    assert g.growths["capacity"] >= 1 and g.sorts >= 1
    assert (g.sorts, g.rebuilds, g.growths, g.halts, g.comm_stats) == (e.sorts, e.rebuilds, e.growths, e.halts,
                                                                       e.comm_stats)
    assert g.history == e.history
    assert g.host_reads == g.windows + g.growths["capacity"]
    assert e.host_reads > g.host_reads
    assert g.graph_captures == 1 + g.growths["capacity"]
    for name in ("fused_bin_deposit_reduced", "fused_bin_gather"):
        assert e_counts[name] == 4 * 20 and g_counts[name] == 4 * (20 + g.graph_captures)
    for f in dataclasses.fields(g.shard_state):
        assert torch.equal(getattr(g.shard_state, f.name), getattr(e.shard_state, f.name)), f.name
    for f in dataclasses.fields(g.policy_state):
        assert torch.equal(getattr(g.policy_state, f.name), getattr(e.policy_state, f.name)), f.name


@pytest.mark.gpu
def test_tall_column_and_large_capacity(cuda):
    """Shapes off the main path: a 256-cell column (the reduced kernel keeps
    its z sums in registers, so the height is free), and a capacity above
    one block of gather threads."""
    g = max_guard(3)
    grid = (2, 2, 256)
    d, val = _slab(grid, 6000, 24, 7, cuda)
    _close(
        dep.fused_bin_deposit_reduced(d, val, order=3, grid_shape=grid, guard=g),
        dep_ref.fused_bin_deposit_reduced_ref(d, val, order=3, grid_shape=grid, guard=g),
    )
    grid = (3, 3, 3)
    d, val = _slab(grid, 3000, 320, 8, cuda)
    padded = torch.randn(6, *(n + 2 * g for n in grid), device=cuda)
    _close(dep.fused_bin_deposit(d, val, order=3), dep_ref.fused_bin_deposit_ref(d, val, order=3))
    _close(
        gat.fused_bin_gather(d, padded, grid_shape=grid, order=3, guard=g),
        gat_ref.fused_gather_ref(d, padded, grid_shape=grid, order=3, guard=g),
    )
    torch.cuda.synchronize()


def _synthetic_slab(grid, cap, seed, device, *, empty=(), full=()):
    """A slab with a random occupancy per cell (cells ``empty`` hold no
    particle, cells ``full`` fill every slot): occupied slots get offsets in
    [0, 1) and random values; gap slots get val 0 and, as in the port's
    slabs, the offset of one aliased particle from their cell, so most of
    them lie outside every tap window and some inside."""
    rng = np.random.default_rng(seed)
    n_cells = int(np.prod(grid))
    occ = rng.integers(0, cap + 1, n_cells)
    occ[list(empty)] = 0
    occ[list(full)] = cap
    d = rng.random((n_cells, cap, 3)).astype(np.float32)
    val = rng.normal(size=(n_cells, cap, 3)).astype(np.float32)
    gap = np.arange(cap)[None, :] >= occ[:, None]
    val[gap] = 0.0
    cells = np.stack(np.unravel_index(np.arange(n_cells), grid), axis=-1).astype(np.float32)
    alias = (rng.random(3) * np.asarray(grid)).astype(np.float32)
    d[gap] = (alias[None, :] - cells)[np.nonzero(gap)[0]]
    return torch.from_numpy(d).to(device), torch.from_numpy(val).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("grid", [(3, 4, 5), (4, 3, 1)], ids=["3x4x5", "one-cell-columns"])
@pytest.mark.parametrize("cap", [24, 48, 64, 320])
@pytest.mark.parametrize("order", ORDERS)
def test_redesigned_kernels_match_plain_versions(order, cap, grid, cuda):
    """The reduced deposition and the fused gather at capacities below, at
    and above one 32-slot chunk, with an all-gap cell and a full cell, on
    a grid and on columns of one cell."""
    g = max_guard(order)
    d, val = _synthetic_slab(grid, cap, 10 * order + cap, cuda, empty=(1,), full=(0,))
    padded = torch.from_numpy(
        np.random.default_rng(cap).normal(size=(6, *(n + 2 * g for n in grid))).astype(np.float32)).to(cuda)
    _close(
        dep.fused_bin_deposit_reduced(d, val, order=order, grid_shape=grid, guard=g),
        dep_ref.fused_bin_deposit_reduced_ref(d, val, order=order, grid_shape=grid, guard=g),
    )
    got = gat.fused_bin_gather(d, padded, grid_shape=grid, order=order, guard=g)
    _close(got, gat_ref.fused_gather_ref(d, padded, grid_shape=grid, order=order, guard=g))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_a_1000_cell_column_runs_and_matches_plain(cuda):
    """A column of 1000 cells: the reduced kernel's shared memory does not
    grow with the column, so the wrapper takes it."""
    grid, g = (1, 1, 1000), max_guard(3)
    d, val = _synthetic_slab(grid, 8, 5, cuda)
    _close(
        dep.fused_bin_deposit_reduced(d, val, order=3, grid_shape=grid, guard=g),
        dep_ref.fused_bin_deposit_reduced_ref(d, val, order=3, grid_shape=grid, guard=g),
    )
    padded = torch.randn(6, *(n + 2 * g for n in grid), device=cuda)
    _close(
        gat.fused_bin_gather(d, padded, grid_shape=grid, order=3, guard=g),
        gat_ref.fused_gather_ref(d, padded, grid_shape=grid, order=3, guard=g),
    )
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("order", ORDERS)
def test_reduced_kernel_equals_packed_kernel_then_plain_z_pass(order, cuda):
    """Bit identity: the reduced kernel sums each tile as the packed kernel
    does (kept slots in order) and adds the tiles to each row in ascending
    tap order, as the plain z pass does."""
    g = max_guard(order)
    for grid, (d, val) in (((6, 5, 7), _slab((6, 5, 7), 1500, 40, order, cuda)),
                           ((3, 4, 9), _synthetic_slab((3, 4, 9), 48, order, cuda, empty=(2,), full=(5,)))):
        reduced = dep.fused_bin_deposit_reduced(d, val, order=order, grid_shape=grid, guard=g)
        packed = dep.fused_bin_deposit(d, val, order=order)
        assert torch.equal(reduced, dep_ref.column_z_pass(packed, order=order, grid_shape=grid, guard=g))


@pytest.mark.gpu
@pytest.mark.parametrize("order", ORDERS)
def test_repeated_launches_are_bit_equal(order, cuda):
    grid, g = (5, 6, 7), max_guard(order)
    d, val = _synthetic_slab(grid, 40, 20 + order, cuda, empty=(3,), full=(4,))
    padded = torch.randn(6, *(n + 2 * g for n in grid), device=cuda)
    m, n = support(order, True)[0], support(order, False)[0] ** 2
    gen = torch.Generator(device=cuda).manual_seed(order)
    shapes = ((1001, 33, m), (1001, 33, n), (1001, m, n))
    wx, byz, gn = (torch.rand(shape, generator=gen, device=cuda) for shape in shapes)
    runs = [(dep.fused_bin_deposit_reduced(d, val, order=order, grid_shape=grid, guard=g),
             gat.fused_bin_gather(d, padded, grid_shape=grid, order=order, guard=g),
             dep.fused_bin_deposit(d, val, order=order), gat.bin_gather(wx, byz, gn)) for _ in range(2)]
    for first, second in zip(*runs):
        assert torch.equal(first, second)


PACKED_CASES = [((3, 4, 5), cap) for cap in (24, 48, 64, 320)] + [((4, 3, 1), 48)] + [
    ((41, 61, 8), cap) for cap in (24, 48, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("grid,cap", PACKED_CASES, ids=[f"{'x'.join(map(str, g))}-cap{c}" for g, c in PACKED_CASES])
@pytest.mark.parametrize("order", ORDERS)
def test_packed_kernel_is_bit_equal_to_plain(order, grid, cap, cuda):
    """The packed deposition sums each tile element as a chain of fmaf over
    the kept slots in order, with the products rounded as the plain
    version rounds them: bit for bit, at capacities below, at and above
    one 32-slot chunk, with an all-gap and a full cell, on grids whose cell
    count no block's cells divide (20 008 cells: a partial last lane and
    block). The plain version runs on the CPU: PyTorch on CUDA divides by
    a Python scalar as a multiply by its rounded reciprocal, so the
    third-order spline's t^3 / 6 can differ there by one rounding."""
    d, val = _synthetic_slab(grid, cap, 100 * order + cap, cuda, empty=(1,), full=(0,))
    geo = dep.packed_geometry(d.shape[0], order, cap)
    if np.prod(grid) > 100:
        assert geo.cells_per_lane > 1 and d.shape[0] % (geo.cells_per_lane * geo.lanes_per_block) != 0
        assert d.shape[0] % geo.cells_per_lane != 0
    got = dep.fused_bin_deposit(d, val, order=order)
    assert torch.equal(got.cpu(), dep_ref.fused_bin_deposit_ref(d.cpu(), val.cpu(), order=order))


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [32, 7, 33], ids=["cap-32", "cap-7", "cap-33"])
@pytest.mark.parametrize("order", ORDERS)
def test_bin_gather_at_every_stagger(order, cap, cuda):
    """The unfused gather at the (M, N) of every field stagger, at capacity
    32 (every group copied by the TMA but a ragged last one) and at odd
    capacities, on 1001 cells (no group size divides it), and on operands
    that start 4 bytes past a 16-byte boundary (every group copied in
    4-byte loads)."""
    gen = torch.Generator(device=cuda).manual_seed(10 * order + cap)
    for stagger in (NO_STAGGER,) + EB_STAGGERS:
        (tx, ty, tz) = (support(order, st)[0] for st in stagger)
        shapes = ((1001, cap, tx), (1001, cap, ty * tz), (1001, tx, ty * tz))
        wx, byz, g = (torch.rand(shape, generator=gen, device=cuda) for shape in shapes)
        g = g * 2 - 1
        _close(gat.bin_gather(wx, byz, g), gat_ref.bin_gather_ref(wx, byz, g))
        shifted = [torch.empty(x.numel() + 1, device=cuda)[1:].view(x.shape).copy_(x) for x in (wx, byz, g)]
        assert all(x.data_ptr() % 16 == 4 and x.is_contiguous() for x in shifted)
        _close(gat.bin_gather(*shifted), gat_ref.bin_gather_ref(wx, byz, g))
    torch.cuda.synchronize()


def _off16(x):
    """x copied to one element past a 16-byte boundary (4 bytes in
    float32, 2 in bfloat16)."""
    y = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:].view(x.shape).copy_(x)
    assert y.data_ptr() % 16 == x.element_size() and y.is_contiguous()
    return y


def _outer_operands(gen, cap, m, n, dtype, device):
    """a (1001, cap, M) with every seventh cell all zero, b (1001, cap, N)."""
    a = torch.randn((1001, cap, m), generator=gen, device=device)
    a[::7] = 0.0
    b = torch.randn((1001, cap, n), generator=gen, device=device)
    return a.to(dtype), b.to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("cap", [7, 32, 33, 48], ids=["cap-7", "cap-32", "cap-33", "cap-48"])
@pytest.mark.parametrize("order", ORDERS)
def test_bin_outer_product_at_every_stagger(order, cap, dtype, cuda):
    """The unfused deposition at the (M, N) of every current stagger, on
    1001 cells (a ragged last group) with all-zero a cells: at capacities 32
    and 48 every cell is copied by the TMA; at 7 and 33 only where M and N
    are multiples of 4 (float32) or 8 (bfloat16), the element route
    otherwise; operands one element past a 16-byte boundary take the element
    route at every capacity. Both routes, and two launches, give the same
    bits: each output is a chain of fmaf over ascending slots."""
    gen = torch.Generator(device=cuda).manual_seed(100 * order + cap)
    for stagger in (NO_STAGGER,) + CURRENT_STAGGER:
        (tx, ty, tz) = (support(order, st)[0] for st in stagger)
        a, b = _outer_operands(gen, cap, tx, ty * tz, dtype, cuda)
        got = dep.bin_outer_product(a, b)
        _close(got, dep_ref.bin_outer_product_ref(a, b))
        assert bool((got[::7] == 0).all())
        assert torch.equal(dep.bin_outer_product(_off16(a), _off16(b)), got)
        assert torch.equal(dep.bin_outer_product(a, b), got)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("m,n", [(1, 4), (6, 16), (9, 5)], ids=["M-1", "M-6", "M-9"])
def test_bin_outer_product_outside_the_templated_shapes(m, n, dtype, cuda):
    """The unfused deposition's run-time-M instance (M outside 2..5; M 9
    takes two rounds of five sums), aligned and one element off a 16-byte
    boundary, bit-equal to each other."""
    gen = torch.Generator(device=cuda).manual_seed(10 * m + n)
    a, b = _outer_operands(gen, 32, m, n, dtype, cuda)
    got = dep.bin_outer_product(a, b)
    _close(got, dep_ref.bin_outer_product_ref(a, b))
    assert torch.equal(dep.bin_outer_product(_off16(a), _off16(b)), got)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [32, 7], ids=["cap-32", "cap-7"])
@pytest.mark.parametrize("m,n", [(3, 7), (6, 16)], ids=["N-7", "M-6"])
def test_bin_gather_outside_the_templated_shapes(m, n, cap, cuda):
    """The unfused gather's run-time-N instance: an N that no stagger has,
    and an M over the templated sums' 5, on 1001 cells, aligned and 4 bytes
    off a 16-byte boundary."""
    gen = torch.Generator(device=cuda).manual_seed(100 * m + n + cap)
    shapes = ((1001, cap, m), (1001, cap, n), (1001, m, n))
    wx, byz, g = (torch.rand(shape, generator=gen, device=cuda) for shape in shapes)
    g = g * 2 - 1
    want = gat_ref.bin_gather_ref(wx, byz, g)
    _close(gat.bin_gather(wx, byz, g), want)
    shifted = [torch.empty(x.numel() + 1, device=cuda)[1:].view(x.shape).copy_(x) for x in (wx, byz, g)]
    assert all(x.data_ptr() % 16 == 4 and x.is_contiguous() for x in shifted)
    _close(gat.bin_gather(*shifted), want)
    torch.cuda.synchronize()


def _assert_bit_equal(a, b, *, policy=True):
    assert (a.sorts, a.rebuilds, a.growths, a.state.step) == (b.sorts, b.rebuilds, b.growths, b.state.step)
    for part in ("fields", "particles", "layout", "slab"):
        x, y = getattr(a.state, part), getattr(b.state, part)
        assert (x is None) == (y is None), part
        for f in dataclasses.fields(x) if x is not None else ():
            assert torch.equal(getattr(x, f.name), getattr(y, f.name)), f"{part}.{f.name}"
    if policy:
        for f in dataclasses.fields(a.policy_state):
            assert torch.equal(getattr(a.policy_state, f.name), getattr(b.policy_state, f.name)), f.name


SMALL = dict(grid=(32, 32, 32), ppc=2, order=3,
             policy=SortPolicyConfig(sort_interval=7, min_sort_interval=3, sort_trigger_perf_enable=False))


@pytest.mark.gpu
def test_host_loop_is_bit_equal_to_captured_window(cuda):
    """20 steps of the host-driven loop (eager, decisions read on the host,
    the performance trigger off) give the captured window's state exactly,
    sorts included; each step launches each kernel once, without a graph."""
    host, wind = make_simulation(scenario("uniform", **SMALL)), make_simulation(scenario("uniform", **SMALL))
    kernels.reset_launch_counts()
    host.run(20, window=None)
    assert {k: v for k, v in kernels.launch_counts().items() if v} == _want_launches(host, 20)
    assert host.graph_captures == 0 and host.windows == 0 and host.host_reads >= 3 * 20
    wind.run(20, window=10)
    assert wind.graph_captures == 1 and host.sorts >= 2
    _assert_bit_equal(host, wind, policy=False)  # the host loop keeps its policy on the host


@pytest.mark.gpu
@pytest.mark.parametrize("sort", ["incremental", "global"])
def test_checkpoint_resume_is_bit_equal(sort, cuda, tmp_path):
    """Saved at step 10, loaded into a fresh driver on the card and run 10
    more steps: the uninterrupted 20-step run, bit for bit, history
    included."""
    kw = dict(SMALL, sort=sort, window=5, diagnostics_every=1)
    whole = make_simulation(scenario("uniform", **kw))
    whole.run(20)
    first = make_simulation(scenario("uniform", **kw))
    first.run(10)
    first.save(str(tmp_path / "ck"))
    resumed = load_simulation(str(tmp_path / "ck"))
    assert resumed.device.type == "cuda" and resumed.state.step == 10
    resumed.run(10)
    _assert_bit_equal(whole, resumed)
    assert whole.history == resumed.history


@pytest.mark.gpu
@pytest.mark.parametrize(
    "sort,extra",
    [("rebuild", dict(capacity=8, u_thermal=0.4)), ("global", {}), ("none", dict(deposition="scatter", gather="scatter"))],
    ids=["rebuild-growth", "global", "none-scatter"],
)
def test_sort_modes_captured_match_eager(sort, extra, cuda):
    """Each ablation sort mode captured (its decision an IF node, one host
    read a window; two more at a growth) against the same window run
    eagerly: exactly, but for the scatter deposition's float atomics
    (``none``), whose fields agree to 1e-4 of their largest magnitude, as the
    modes do in `test_windowed_backends_agree`;
    ``rebuild`` in bins of 8 grows its capacity."""
    spec = scenario("uniform", grid=(8, 8, 8), order=2, sort=sort, **extra)
    sims = {}
    for graphs in (True, False):
        sim = make_simulation(spec)
        sim.use_graphs = graphs
        sim.run(12, window=6, diagnostics_every=1)
        sims[graphs] = sim
    g, e = sims[True], sims[False]
    assert g.host_reads == g.windows + 2 * g.growths["capacity"]
    assert g.halts == e.halts
    if sort == "rebuild":
        assert g.growths["capacity"] >= 1
    if sort != "none":
        assert g.history == e.history
        _assert_bit_equal(g, e)
        return
    assert torch.equal(g.state.layout.slots, e.state.layout.slots)
    for a, b in zip(g.state.fields.all(), e.state.fields.all()):
        _close(a, b, rtol=0, atol=1e-4 * max(float(b.abs().max()), 1e-30))


# -- fault tolerance in the captured window --------------------------------------------

FT = dict(grid=(32, 32, 32), ppc=2, order=3, steps=24, window=8, diagnostics_every=4)


@pytest.mark.gpu
def test_sentinel_on_is_bit_equal_to_off(cuda):
    """The sentinel only reads: the captured run with it on is the run with
    it off, bit for bit, with one host read a window."""
    off = make_simulation(scenario("uniform", **FT))
    on = make_simulation(scenario("uniform", **FT, health={"enable": True}))
    off.run()
    kernels.reset_launch_counts()
    on.run()
    assert {k: v for k, v in kernels.launch_counts().items() if v} == _want_launches(on, 24 + on.graph_captures)
    _assert_bit_equal(on, off)
    assert on.history == off.history and on.halts == {} and on.retries == 0
    assert on.host_reads == on.windows == off.windows == 3 and on.graph_captures == 1


@pytest.mark.gpu
@pytest.mark.parametrize("kind,halt", [("nan_field", "nonfinite"), ("nan_momentum", "nonfinite"),
                                       ("charge_scale", "invariant")])
def test_fault_rolls_back_inside_the_captured_window(kind, halt, cuda):
    """A fault armed at step 10 halts the captured window at step 11; the
    window is rolled back in place (no recapture) and retried clean: one
    halt, one retry, the clean run's state bit for bit, and one host read
    per window entered: the three clean windows, the halted one and the
    extra window of the halved retry."""
    clean = make_simulation(scenario("uniform", **FT, health={"enable": True}))
    clean.run()
    dispatch.reset_counters()
    sim = make_simulation(scenario("uniform", **FT, health={"enable": True},
                                   fault={"kind": kind, "step": 10, "component": "ez"}))
    sim.run()
    assert sim.halts == {halt: 1} and sim.retries == 1 and sim.fault_injector.fired == 1
    assert sim.config.backend == "auto" and dispatch.counters["plain_on_card"] == 0  # no demotion
    _assert_bit_equal(sim, clean)
    assert sim.history == clean.history
    assert sim.host_reads == sim.windows == 5 and sim.graph_captures == 1


def _nonfinite_cells(x, n_cells):
    """Which of n_cells leading rows of x hold a non-finite value."""
    return ~torch.isfinite(x.reshape(n_cells, -1)).all(dim=1)


@pytest.mark.gpu
@pytest.mark.parametrize("poison", ["nan", "inf"])
@pytest.mark.parametrize("order", ORDERS)
def test_kernels_tolerate_nonfinite_inputs(order, poison, cuda):
    """NaN or Inf in an occupied slot's offsets or values, in a gap slot's
    offsets (a gap slot aliases particle 0), or in the fields: each of
    kernels #1-#5 runs without a CUDA error, the context stays usable, and
    only cells a poisoned occupied slot (or a poisoned field point) reaches
    come out non-finite."""
    bad = float(poison)
    grid, cap = (5, 4, 6), 24
    nx, ny, nz = grid
    n_cells = nx * ny * nz
    g = max_guard(order)
    d, val = _synthetic_slab(grid, cap, 40 + order, cuda, empty=(0,), full=(1,))
    occupied = val.abs().sum(-1) != 0
    held = occupied.any(dim=1).nonzero().flatten()
    hit_cells = held[[1, len(held) // 2, -1]]
    slot = occupied[hit_cells].float().argmax(dim=1)  # an occupied slot of each
    d[hit_cells[0], slot[0], 1] = bad
    val[hit_cells[1], slot[1], 2] = bad
    d[hit_cells[2], slot[2], 0] = bad
    gap = (~occupied).nonzero()[:5]
    d[gap[:, 0], gap[:, 1]] = bad  # never read back, never counted
    poisoned = torch.zeros(n_cells, dtype=torch.bool, device=cuda)
    poisoned[hit_cells] = True

    # #1: one (3, T, T*T) tile per cell
    packed = dep.fused_bin_deposit(d, val, order=order)
    assert not (_nonfinite_cells(packed, n_cells) & ~poisoned).any()
    assert _nonfinite_cells(packed, n_cells)[hit_cells[1]]
    # #2: one accumulator per z-column
    reduced = dep.fused_bin_deposit_reduced(d, val, order=order, grid_shape=grid, guard=g)
    col_poisoned = poisoned.reshape(nx * ny, nz).any(dim=1)
    assert not (_nonfinite_cells(reduced, nx * ny) & ~col_poisoned).any()
    # #3: poisoned field points reach the live slots of the cells whose
    # window holds them; poisoned offsets reach no other slot
    padded = torch.randn((6, *(k + 2 * g for k in grid)), device=cuda)
    padded[2, g + 2, g + 1, g + 3] = bad
    gathered = gat.fused_bin_gather(d, padded, grid_shape=grid, order=order, guard=g)
    cells = torch.arange(n_cells, device=cuda).reshape(grid)
    near = torch.zeros(n_cells, dtype=torch.bool, device=cuda)
    t = support(order, False)[0] + 2
    near[cells[max(0, 2 - t):2 + t, max(0, 1 - t):1 + t, max(0, 3 - t):3 + t].reshape(-1)] = True
    live_bad = ~torch.isfinite(gathered).all(-1) & occupied
    assert not (live_bad.any(dim=1) & ~(near | poisoned)).any()
    # #4 and #5: one cell's operands reach that cell alone
    m, n = support(order, True)[0], support(order, False)[0] ** 2
    a = torch.randn((n_cells, cap, m), device=cuda)
    b = torch.randn((n_cells, cap, n), device=cuda)
    a[hit_cells[0], 3, 1] = bad
    b[hit_cells[1], 0, 2] = bad
    outer = dep.bin_outer_product(a, b)
    assert not (_nonfinite_cells(outer, n_cells) & ~poisoned).any()
    assert _nonfinite_cells(outer, n_cells)[hit_cells[:2]].all()
    wx = torch.rand((n_cells, cap, m), device=cuda)
    byz = torch.rand((n_cells, cap, n), device=cuda)
    gn = torch.randn((n_cells, m, n), device=cuda)
    gn[hit_cells[2], 0, 0] = bad
    wx[hit_cells[0], 2, 0] = bad
    e = gat.bin_gather(wx, byz, gn)
    assert not (_nonfinite_cells(e, n_cells) & ~poisoned).any()
    assert _nonfinite_cells(e, n_cells)[hit_cells[2]]
    torch.cuda.synchronize()
    # the context still runs kernels, and they still match their plain versions
    d2, val2 = _synthetic_slab(grid, cap, 7, cuda)
    assert torch.equal(dep.fused_bin_deposit(d2, val2, order=order).cpu(),
                       dep_ref.fused_bin_deposit_ref(d2.cpu(), val2.cpu(), order=order))
    torch.cuda.synchronize()


# -- ensembles and the service on the card ---------------------------------------------


def _assert_member_bit_equal(ens, i, solo, *, layout=True):
    """Member i of a bucket against its solo run: counters, history, state
    and policy state bit for bit (the bins too where the capacities agree)."""
    st = ens.member_state(i)
    assert (int(ens.sorts[i]), int(ens.rebuilds[i]), st.step) == (solo.sorts, solo.rebuilds, solo.state.step)
    assert ens.histories[i] == solo.history
    for part in ("fields", "particles") + (("layout", "slab") if layout else ()):
        x, y = getattr(st, part), getattr(solo.state, part)
        for f in dataclasses.fields(x):
            assert torch.equal(getattr(x, f.name), getattr(y, f.name)), f"member {i} {part}.{f.name}"
    if layout:
        pol = ens.member_policy_state(i)
        for f in dataclasses.fields(pol):
            assert torch.equal(getattr(pol, f.name), getattr(solo.policy_state, f.name)), f.name


@pytest.mark.gpu
def test_ensemble_bucket_is_bit_equal_to_solo_runs(cuda):
    """A 3-member bucket at 32^3 captured as one graph: each member bit-equal
    to its own captured solo run, one capture, one host read a window, and
    each member's kernels launched once a step."""
    es = EnsembleSpec.replicate(scenario("uniform", **SMALL, steps=20, window=10, diagnostics_every=5), 3)
    ens = make_ensemble(es)
    bucket = ens.sims[0]
    kernels.reset_launch_counts()
    ens.run()
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    assert counts == _want_launches(bucket, 3 * 20 + bucket.graph_captures)  # one warm-up step a capture
    assert bucket.graph_captures == 1 and bucket.windows == 2 and bucket.host_reads == 2
    assert int(bucket.sorts.sum()) >= 3, "no member sorted: the test is vacuous"
    for i, m in enumerate(es.members()):
        solo = make_simulation(m)
        solo.run()
        _assert_member_bit_equal(bucket, i, solo)


@pytest.mark.gpu
def test_ensemble_per_member_targets_on_the_card(cuda):
    """Per-member targets [5, 12, 9] in windows of 6: two windows, one
    capture, each member stopped at its own target, bit-equal to a solo run
    of its length."""
    es = EnsembleSpec.replicate(scenario("uniform", **SMALL, window=6), 3)
    ens = make_ensemble(es)
    bucket = ens.sims[0]
    bucket.run([5, 12, 9])
    assert list(bucket.host_step) == [5, 12, 9] and [bucket.member_state(i).step for i in range(3)] == [5, 12, 9]
    assert bucket.graph_captures == 1 and bucket.windows == bucket.host_reads == 2
    for i, (m, n) in enumerate(zip(es.members(), (5, 12, 9))):
        solo = make_simulation(m)
        solo.run(n)
        _assert_member_bit_equal(bucket, i, solo)


def _lattice_members(specs, device, shape=(6, 6, 6)):
    """Lattice plasmas, 2^3 a cell, with numpy thermal momenta: one (fields,
    particles) pair per (seed, u_thermal)."""
    from repro_torch.pic import FieldState, ParticleState

    out = []
    off = (np.arange(2) + 0.5) / 2
    cells = np.stack(np.meshgrid(*(np.arange(n) for n in shape), indexing="ij"), -1).reshape(-1, 1, 3)
    lattice = np.stack(np.meshgrid(off, off, off, indexing="ij"), -1).reshape(1, -1, 3)
    pos = (cells + lattice).reshape(-1, 3).astype(np.float32)
    for seed, u_thermal in specs:
        u = (u_thermal * np.random.default_rng(seed).normal(size=pos.shape)).astype(np.float32)
        parts = ParticleState(pos=torch.from_numpy(pos).to(device), u=torch.from_numpy(u).to(device),
                              w=torch.full((len(pos),), 1 / 8, device=device),
                              alive=torch.ones(len(pos), dtype=torch.bool, device=device))
        out.append((FieldState.zeros(shape, device=device), parts))
    return out


GROWTH_MEMBERS = [(0, 0.5), (1, 0.02), (2, 0.02)]
INTERVAL_ONLY = SortPolicyConfig(sort_interval=10, sort_trigger_perf_enable=False, sort_trigger_empty_ratio=2.0,
                                 sort_trigger_full_ratio=2.0, sort_trigger_rebuild_count=10**6)


@pytest.mark.gpu
def test_ensemble_growth_isolation_on_the_card(cuda):
    """One hot member overflows its bins at capacity 12 and the bucket grows:
    the hot member bit-equal to its solo run (which grows the same way), the
    mild siblings, re-binned at the grown capacity, bit-equal to solo runs
    that never grow; captures: one, and one more a growth."""
    from repro_torch.pic import EnsembleSimulation, GridSpec, PICConfig, Simulation

    cfg = PICConfig(grid=GridSpec(shape=(6, 6, 6)), dt=0.2, order=1, capacity=12)
    ens = EnsembleSimulation(_lattice_members(GROWTH_MEMBERS, cuda), cfg, INTERVAL_ONLY)
    ens.run(28, window=7)
    assert ens.growths["capacity"] >= 1 and ens.graph_captures == 1 + ens.growths["capacity"]
    assert ens.host_reads == ens.windows + 2 * ens.growths["capacity"]
    for i, member in enumerate(_lattice_members(GROWTH_MEMBERS, cuda)):
        solo = Simulation(*member, cfg, policy=INTERVAL_ONLY)
        solo.run(28, window=7)
        if i == 0:
            assert solo.config.capacity == ens.config.capacity
        else:
            assert solo.config.capacity == 12, "a mild sibling overflowed on its own: the claim is vacuous"
        _assert_member_bit_equal(ens, i, solo, layout=i == 0)


@pytest.mark.gpu
def test_service_repeat_batch_captures_nothing(cuda):
    """Three jobs of one signature make one batch and one capture; three more
    replay the cached window: no capture, no window built."""
    import asyncio

    from repro_torch.launch.sim_serve import SimService

    spec = scenario("uniform", grid=(8, 8, 8), ppc=2, order=3, steps=8, window=4)

    async def body():
        svc = SimService(max_batch=3, batch_wait=0.25)
        await svc.start()
        rounds = []
        for _ in range(2):
            ids = [await svc.submit(spec.to_json()) for _ in range(3)]
            finals = {}
            for job_id in ids:
                async for event in svc.results(job_id):
                    finals[job_id] = event
            rounds.append(([finals[j] for j in ids], svc.graph_captures, svc.window_builds))
        await svc.close()
        return svc, rounds

    svc, rounds = asyncio.run(body())
    (first, caps1, builds1), (second, caps2, builds2) = rounds
    assert [f["event"] for f in first + second] == ["done"] * 6 and {f["batch_size"] for f in first + second} == {3}
    assert (caps1, builds1, caps2, builds2) == (1, 1, 1, 1)
    assert svc.cache.stats()["hits"] == 1 and svc.cache.stats()["misses"] == 1
    assert [f["history"] for f in second] == [f["history"] for f in first]
    assert [f["diagnostics"] for f in second] == [f["diagnostics"] for f in first]
