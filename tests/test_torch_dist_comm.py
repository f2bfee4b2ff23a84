"""The port's shard exchange against numpy oracles of the global periodic
array, and its pure helpers against the reference's.

- `ring_shift`: shard j receives shard j - 1's block for ``+1`` (the
  reference's ``ppermute`` over ``_ring(+1)``);
- `halo_extend` (serialized and overlapped) at guard widths 1-2 (orders 1-3)
  on 1x1, 2x1 and 4x2 meshes: each shard's padded block equals the slice of
  the globally wrap-padded array; `halo_reduce` folds each shard's padded
  contributions onto the global periodic grid as a scatter-add does
  (integer-valued float32 data, so every sum is exact); the overlapped
  forms bit-equal to the serialized;
- `migrate_axis` on crafted particles crossing every face and corner, with
  send-buffer and dead-slot overflow, against a numpy oracle of the
  reference's pack / exchange / insert rules (index order, dead slots
  lowest first, prev's buffer before next's);
- the compression helpers and the split planner bit for bit against
  `repro.distributed` (pure functions, no mesh), and the guard-padded curls
  against `repro.pic.maxwell`'s.

Everything is exact (`assert_array_equal`), the curls to rtol 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.distributed import compression as rcomp  # noqa: E402
from repro.distributed import sharding as rshard  # noqa: E402
from repro.pic import maxwell as rmaxwell  # noqa: E402
from repro_torch.core.shape_functions import max_guard  # noqa: E402
from repro_torch.distributed import compression as tcomp  # noqa: E402
from repro_torch.distributed import sharding as tshard  # noqa: E402
from repro_torch.distributed.comm import CommSpec  # noqa: E402
from repro_torch.pic import distributed as tdist  # noqa: E402
from repro_torch.pic import maxwell as tmaxwell  # noqa: E402
from repro_torch.pic.grid import GridSpec  # noqa: E402

MESHES = [(1, 1), (2, 1), (4, 2)]
LOCAL = (6, 6, 5)  # nx, ny >= 2g at every order: the overlapped reduce's own branch runs


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blocks(g: np.ndarray, sx: int, sy: int) -> np.ndarray:
    """(NX, NY, NZ) -> [SX, SY, nx, ny, nz]."""
    nxg, nyg, nz = g.shape
    return g.reshape(sx, nxg // sx, sy, nyg // sy, nz).transpose(0, 2, 1, 3, 4)


def _ints(rng, shape) -> np.ndarray:
    return rng.integers(-50, 50, size=shape).astype(np.float32)


def test_ring_shift_direction():
    x = torch.arange(4 * 3).reshape(4, 3)
    np.testing.assert_array_equal(tdist.ring_shift(x, 0, +1).numpy(), np.roll(x.numpy(), 1, axis=0))
    # shard j receives shard j - 1's block (the reference's _ring(+1): i -> i + 1)
    for j in range(4):
        np.testing.assert_array_equal(tdist.ring_shift(x, 0, +1)[j].numpy(), x[(j - 1) % 4].numpy())
        np.testing.assert_array_equal(tdist.ring_shift(x, 0, -1)[j].numpy(), x[(j + 1) % 4].numpy())
    u = torch.tensor([[1, 65535], [2, 40000]], dtype=torch.uint16)
    assert tdist.ring_shift(u, 0, 1).to(torch.int64).tolist() == [[2, 40000], [1, 65535]]


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_halo_extend_matches_global_wrap(mesh, order):
    sx, sy = mesh
    g = max_guard(order)
    nx, ny, nz = LOCAL
    glob = _ints(np.random.default_rng(order), (sx * nx, sy * ny, nz))
    wrapped = np.pad(glob, g, mode="wrap")
    f = torch.from_numpy(_blocks(glob, sx, sy).copy())
    for overlap in (False, True):
        cfg = tdist.DistConfig(local_grid=GridSpec(shape=LOCAL), dt=0.1, order=order,
                               comm=CommSpec(overlap_halo=overlap))
        got = tdist._extend_all(f, g, cfg).numpy()
        assert got.shape == (sx, sy, nx + 2 * g, ny + 2 * g, nz + 2 * g)
        for a in range(sx):
            for b in range(sy):
                np.testing.assert_array_equal(got[a, b], wrapped[a * nx:a * nx + nx + 2 * g, b * ny:b * ny + ny + 2 * g],
                                              err_msg=f"shard ({a},{b}), overlap {overlap}")


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_halo_reduce_matches_global_scatter_add(mesh, order):
    sx, sy = mesh
    g = max_guard(order)
    nx, ny, nz = LOCAL
    nxg, nyg = sx * nx, sy * ny
    padded = _ints(np.random.default_rng(10 + order), (sx, sy, nx + 2 * g, ny + 2 * g, nz + 2 * g))
    oracle = np.zeros((nxg, nyg, nz), np.float32)
    for a in range(sx):
        for b in range(sy):
            ix = (a * nx - g + np.arange(nx + 2 * g)) % nxg
            iy = (b * ny - g + np.arange(ny + 2 * g)) % nyg
            iz = (np.arange(nz + 2 * g) - g) % nz
            np.add.at(oracle, np.ix_(ix, iy, iz), padded[a, b])
    p = torch.from_numpy(padded)
    outs = {}
    for overlap in (False, True):
        cfg = tdist.DistConfig(local_grid=GridSpec(shape=LOCAL), dt=0.1, order=order,
                               comm=CommSpec(overlap_halo=overlap))
        outs[overlap] = tdist._reduce_all(p, g, cfg).numpy()
        np.testing.assert_array_equal(outs[overlap], _blocks(oracle, sx, sy), err_msg=f"overlap {overlap}")


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_overlapped_exchange_bit_equal_to_serialized(mesh):
    """Random floats (sums that round): the overlapped forms keep the
    serialized routing and add grouping, bit for bit."""
    sx, sy = mesh
    rng = np.random.default_rng(7)
    for g in (1, 2):
        f = torch.from_numpy(rng.normal(size=(sx, sy, *LOCAL)).astype(np.float32))
        serial = tdist.halo_extend(tdist.halo_extend(f, g, 0, 0), g, 1, 1)
        assert torch.equal(tdist.halo_extend_overlapped(f, g), serial)
        zf = torch.from_numpy(rng.normal(size=(sx, sy, LOCAL[0] + 2 * g, LOCAL[1] + 2 * g, LOCAL[2]))
                              .astype(np.float32))
        serial = tdist.halo_reduce(tdist.halo_reduce(zf, g, 1, 1), g, 0, 0)
        assert torch.equal(tdist.halo_reduce_overlapped(zf, g), serial)


def test_first_of_stable_order_is_the_stable_argsort():
    rng = np.random.default_rng(3)
    mask = torch.from_numpy(rng.random((3, 2, 50)) < 0.3)
    for k in (1, 7, 50, 80):
        want = torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)[..., :k]
        assert torch.equal(tdist.first_of_stable_order(mask, k), want)


# -- migration ---------------------------------------------------------------------


def _np_migrate(pos, u, w, alive, *, coord, extent, shard_axis, cap):
    """The reference's migrate_axis, shard by shard in numpy: the first
    ``cap`` leavers each way in index order are packed (the rest stay,
    counted), shifted into the receiver's frame and sent; each shard lands
    its previous neighbour's buffer, then its next's, into its dead slots,
    lowest index first, dropping (counting) what finds none."""
    pos, u, w, alive = pos.copy(), u.copy(), w.copy(), alive.copy()
    sx, sy, n = alive.shape
    shape = (sx, sy)
    sent, overflow = {}, np.zeros(shape, np.int64)
    for a in range(sx):
        for b in range(sy):
            x = pos[a, b, :, coord]
            for side, leave in (("hi", alive[a, b] & (x >= extent)), ("lo", alive[a, b] & (x < 0))):
                idx = np.flatnonzero(leave)
                take, overflow[a, b] = idx[:cap], overflow[a, b] + max(len(idx) - cap, 0)
                rows = pos[a, b, take].copy()
                rows[:, coord] += -extent if side == "hi" else extent
                sent[(a, b, side)] = (rows, u[a, b, take].copy(), w[a, b, take].copy())
    for a in range(sx):
        for b in range(sy):
            for side in ("hi", "lo"):
                x = pos[a, b, :, coord]
                leave = alive[a, b] & ((x >= extent) if side == "hi" else (x < 0))
                alive[a, b, np.flatnonzero(leave)[:cap]] = False
    dropped = np.zeros(shape, np.int64)
    arrived = np.zeros_like(alive)
    size = (sx, sy)[shard_axis]
    for a in range(sx):
        for b in range(sy):
            j = (a, b)[shard_axis]
            prev = [a, b]
            prev[shard_axis] = (j - 1) % size
            nxt = [a, b]
            nxt[shard_axis] = (j + 1) % size
            for src, side in ((tuple(prev), "hi"), (tuple(nxt), "lo")):
                rows_p, rows_u, rows_w = sent[(*src, side)]
                dead = np.flatnonzero(~alive[a, b])
                k = min(len(dead), len(rows_p))
                dropped[a, b] += len(rows_p) - k
                slot = dead[:k]
                pos[a, b, slot], u[a, b, slot], w[a, b, slot] = rows_p[:k], rows_u[:k], rows_w[:k]
                alive[a, b, slot] = True
                arrived[a, b, slot] = True
    return pos, u, w, alive, overflow, dropped, arrived


def _crafted(mesh, n=12, seed=0):
    """Particles in every face and corner region of a 4x4 local block (and
    inside), a few dead slots a shard."""
    rng = np.random.default_rng(seed)
    sx, sy = mesh
    choices = np.array([-0.6, 0.5, 2.0, 3.5, 4.3])
    pos = np.stack([rng.choice(choices, size=(sx, sy, n)) + rng.random((sx, sy, n)) * 0.1,
                    rng.choice(choices, size=(sx, sy, n)) + rng.random((sx, sy, n)) * 0.1,
                    rng.random((sx, sy, n)) * 4], -1).astype(np.float32)
    u = rng.normal(size=(sx, sy, n, 3)).astype(np.float32)
    w = rng.random((sx, sy, n)).astype(np.float32)
    alive = rng.random((sx, sy, n)) < 0.9
    return pos, u, w, alive


@pytest.mark.parametrize("cap", [1, 2, 16])
@pytest.mark.parametrize("mesh", [(2, 1), (4, 2), (3, 3)], ids=lambda m: f"{m[0]}x{m[1]}")
def test_migrate_axis_matches_numpy_oracle(mesh, cap):
    """x then y, as the step migrates: corners route x-then-y; cap 1 and 2
    overflow the send buffers, the few dead slots drop arrivals."""
    pos, u, w, alive = _crafted(mesh, seed=cap)
    t = [torch.from_numpy(a.copy()) for a in (pos, u, w, alive)]
    want = (pos, u, w, alive)
    totals = []
    for coord in (0, 1):
        kw = dict(coord=coord, extent=4, shard_axis=coord)
        *got_arrays, of, dr, ins = tdist.migrate_axis(*t, mig_cap=cap, local_shape=(4, 4, 4), **kw)
        *want_arrays, w_of, w_dr, w_ins = _np_migrate(*want, cap=cap, **kw)
        for name, g_, w_ in zip(("pos", "u", "w", "alive"), got_arrays, want_arrays):
            np.testing.assert_array_equal(g_.numpy(), w_, err_msg=f"axis {coord}: {name}")
        np.testing.assert_array_equal(of.numpy(), w_of)
        np.testing.assert_array_equal(dr.numpy(), w_dr)
        np.testing.assert_array_equal(ins.numpy(), w_ins)
        totals.append((int(of.sum()), int(dr.sum())))
        t, want = got_arrays, want_arrays
    if cap == 1:
        assert totals[0][0] > 0 and totals[1][0] > 0, totals  # send-side overflow on both axes
    if cap == 16:
        assert sum(d for _, d in totals) > 0, totals  # receive-side drops


def test_migrate_axis_compressed_positions_round_trip():
    """Compressed payloads: weights exact, positions within the uint16 step,
    momenta as their bfloat16 rounding."""
    pos, u, w, alive = _crafted((4, 2), n=40, seed=5)
    alive[:] = np.arange(40) < 30  # ten dead slots a shard: nothing drops
    t = [torch.from_numpy(a.copy()) for a in (pos, u, w, alive)]
    kw = dict(coord=0, extent=4, shard_axis=0, mig_cap=16, local_shape=(4, 4, 4))
    exact = tdist.migrate_axis(*t, **kw)
    comp = tdist.migrate_axis(*t, compress=True, **kw)
    np.testing.assert_array_equal(comp[3].numpy(), exact[3].numpy())
    np.testing.assert_array_equal(comp[2].numpy(), exact[2].numpy())
    step = (4 + 2 * tcomp.POS_MARGIN) / 65536
    assert float((comp[0] - exact[0]).abs().max()) <= step
    np.testing.assert_array_equal(comp[1][comp[6]].numpy(), exact[1][exact[6]].to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize("compress", [False, True], ids=["exact", "compressed"])
@pytest.mark.parametrize("coord", [0, 1])
def test_migrate_axis_arrivals_land_in_range(coord, compress):
    """A particle a hair below 0 leaves low; ``x + extent`` rounds to
    ``extent`` in float32, and a compressed coordinate dequantizes up to a
    step beyond either edge: every arrival still lands inside the
    receiver's block, in its domain, within one quantization step of the
    exact shift."""
    n, extent = 6, 4
    pos = np.full((2, 2, n, 3), 1.5, np.float32)
    pos[:, :, 0, coord] = -1e-7                      # rounds to extent on arrival
    pos[:, :, 1, coord] = np.float32(extent) + 1e-6  # arrives a hair above 0
    pos[:, :, 2, coord] = -3e-5                      # below the top by less than a compressed step
    u = np.zeros((2, 2, n, 3), np.float32)
    w = np.ones((2, 2, n), np.float32)
    alive = np.arange(n) < 3
    alive = np.broadcast_to(alive, (2, 2, n)).copy()
    t = [torch.from_numpy(a.copy()) for a in (pos, u, w, alive)]
    p, _, _, al, of, dr, ins = tdist.migrate_axis(*t, coord=coord, extent=extent, shard_axis=coord, mig_cap=4,
                                                  local_shape=(extent,) * 3, compress=compress)
    assert int(of.sum()) == 0 and int(dr.sum()) == 0
    arrived = p[ins]
    assert arrived.shape[0] == 3 * 4 and bool(al[ins].all())
    assert bool(tdist.in_domain(arrived, (extent,) * 3).all())
    x = arrived[:, coord]
    assert float(x.min()) >= 0.0 and float(x.max()) < extent
    want = np.sort(np.float64([extent - 1e-7, 1e-6, extent - 3e-5] * 4))
    step = (extent + 2 * tcomp.POS_MARGIN) / 65536 if compress else 1e-6
    np.testing.assert_allclose(np.sort(x.double().numpy()), want, rtol=0, atol=step)


# -- pure helpers against the reference ------------------------------------------------


def test_compression_bit_for_bit_with_reference():
    rng = np.random.default_rng(11)
    shape = (6, 5, 40)
    pos = rng.uniform(-2.0, 8.0, size=(500, 3)).astype(np.float32)
    step = np.float32((np.array(shape, np.float32) + 4) / 65536)
    pos[:100] = ((np.round(pos[:100] / step) + 0.5) * step).astype(np.float32)  # halfway cases
    q_t = tcomp.pack_positions(torch.from_numpy(pos), shape)
    q_r = np.asarray(rcomp.pack_positions(jnp.asarray(pos), shape))
    assert q_t.dtype == torch.uint16
    np.testing.assert_array_equal(q_t.to(torch.int64).numpy(), q_r.astype(np.int64))
    np.testing.assert_array_equal(tcomp.unpack_positions(q_t, shape).numpy(),
                                  np.asarray(rcomp.unpack_positions(jnp.asarray(q_r), shape)))
    u = rng.normal(size=(500, 3)).astype(np.float32) * 10
    np.testing.assert_array_equal(tcomp.unpack_momenta(tcomp.pack_momenta(torch.from_numpy(u))).numpy(),
                                  np.asarray(rcomp.unpack_momenta(rcomp.pack_momenta(jnp.asarray(u)))))
    x = rng.normal(size=1000).astype(np.float32) * 3
    for scale, qmin, qmax, dt_t, dt_r in ((np.float32(0.02), -127, 127, torch.int8, jnp.int8),
                                          (np.float32(0.5), 0, 255, torch.uint8, jnp.uint8)):
        q_t = tcomp.quantize_fixed(torch.from_numpy(x), float(scale), qmin=qmin, qmax=qmax, dtype=dt_t)
        q_r = rcomp.quantize_fixed(jnp.asarray(x), scale, qmin=qmin, qmax=qmax, dtype=dt_r)
        np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_r))
        np.testing.assert_array_equal(tcomp.dequantize_fixed(q_t, float(scale)).numpy(),
                                      np.asarray(rcomp.dequantize_fixed(q_r, scale)))
    assert (tcomp.MIG_ROW_BYTES_EXACT, tcomp.MIG_ROW_BYTES_COMPRESSED) == \
        (rcomp.MIG_ROW_BYTES_EXACT, rcomp.MIG_ROW_BYTES_COMPRESSED) == (28, 16)


def test_mesh_splits_match_reference():
    rng = np.random.default_rng(2)
    for n_dev, shape, order in ((8, (16, 8, 16), 1), (8, (8, 8, 32), 3), (6, (12, 12, 4), 2), (4, (4, 4, 2), 3),
                                (12, (24, 18, 9), 1)):
        assert tshard.valid_mesh_splits(n_dev, shape, order) == rshard.valid_mesh_splits(n_dev, shape, order)
    for trial in range(20):
        shape = (16, 8, 16)
        pos = rng.random((400, 3)) * np.array(shape)
        pos[: rng.integers(0, 400)] *= np.array([rng.random(), rng.random(), 1.0])  # skewed loads
        alive = rng.random(400) < 0.9
        assert tshard.plan_balanced_split(8, shape, 1, pos, alive) == \
            rshard.plan_balanced_split(8, shape, 1, pos, alive), trial
    with pytest.raises(ValueError):
        tshard.plan_balanced_split(8, (4, 4, 1), 3, pos, alive)


def test_padded_curls_match_reference():
    rng = np.random.default_rng(4)
    shape, dx = (5, 4, 6), (0.5, 1.0, 2.0)
    for g in (1, 2):
        arrs = [rng.normal(size=tuple(n + 2 * g for n in shape)).astype(np.float32) for _ in range(3)]
        for t_fn, r_fn in ((tmaxwell.curl_b_padded, rmaxwell.curl_b_padded),
                           (tmaxwell.curl_e_padded, rmaxwell.curl_e_padded)):
            got = t_fn(*(torch.from_numpy(a) for a in arrs), g, shape, dx)
            want = r_fn(*(jnp.asarray(a) for a in arrs), g, shape, dx)
            for a, b in zip(got, want):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
        # a stack of shards rides along the leading axes
        stacked = [torch.from_numpy(np.stack([a, a[::-1].copy()])) for a in arrs]
        for a, b in zip(tmaxwell.curl_e_padded(*stacked, g, shape, dx),
                        tmaxwell.curl_e_padded(*(s[1] for s in stacked), g, shape, dx)):
            assert torch.equal(a[1], b)


def test_shard_guard_and_multi_axis_refusals():
    with pytest.raises(ValueError, match="guard width"):
        tdist.DistConfig(local_grid=GridSpec(shape=(1, 4, 4)), dt=0.1, order=2)
    with pytest.raises(NotImplementedError, match="x_axes"):
        tdist.DistConfig(local_grid=GridSpec(shape=(4, 4, 4)), dt=0.1, x_axes=("pod", "data"))
    with pytest.raises(ValueError, match="scatter"):
        tdist.DistConfig(local_grid=GridSpec(shape=(4, 4, 4)), dt=0.1, deposition="scatter")
