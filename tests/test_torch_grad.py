"""Port parity of the gradient subsystem (`repro_torch.grad`) against
`repro.grad`: the autograd permutations, the laser's tensor overrides, the
differentiable window's forward bits and its refusal of the kernel
backends, gradients against `jax.grad` of the reference, finite
differences, the remat memory structure, and the parameter mapping, the
objectives and `GradSpec`.

Both packages start from the same numpy-made particles (their random
generators differ): each facade's `build_particles` is replaced by one that
returns them. The reference runs its ``xla`` backend, the port its
``torch`` route on the CPU. Float64 runs use `jax.enable_x64` (the
reference's own finite-difference tests call `jax.experimental.enable_x64`,
which the installed JAX lacks).

Tolerances:
- exact: permutation and slot-gather forwards, the window's forward
  against the windowed `Simulation` (ints and floats), the f64 grads of
  the three remat policies;
- float64: grads of every learnable leaf within rtol 1e-6 of `jax.grad` of
  the reference's `make_objective` (20 steps); central finite differences
  within rtol 1e-3 (4 steps, orders 1-3), as tests/test_grad.py;
- float32: the loss within rtol 2e-5 of the reference's; each objective
  within rtol 1e-6; the laser with overrides within rtol 1e-6 (and atol
  1e-6 of the field's maximum, for the cosine's zeros).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.api as rapi  # noqa: E402
import repro.api.facade as rfacade  # noqa: E402
import repro.grad as rgrad  # noqa: E402
import repro.pic as rpic  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
import repro_torch.api.facade as tfacade  # noqa: E402
import repro_torch.grad as tgrad  # noqa: E402
import repro_torch.pic as tpic  # noqa: E402
from repro.pic.laser import inject_laser as ref_inject_laser  # noqa: E402
from repro_torch.core import SortPolicyConfig, policy_init  # noqa: E402
from repro_torch.grad.params import StateBuilder  # noqa: E402
from repro_torch.pic.simulation import run_window_diff  # noqa: E402

GRID = (6, 6, 24)
FIELDS = ("ex", "ey", "ez", "bx", "by", "bz")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_particles(grid=GRID, *, u_thermal=0.01, seed=0):
    """lwfa's plasma at ppc 1: a lattice, numpy thermal momenta, and the
    density step at 0.3 of the box (dead, zero-weight particles below)."""
    rng = np.random.default_rng(seed)
    cells = np.stack(np.meshgrid(*(np.arange(n) for n in grid), indexing="ij"), -1).reshape(-1, 3)
    pos = (cells + 0.5).astype(np.float32)
    u = (u_thermal * rng.normal(size=pos.shape)).astype(np.float32)
    w = np.where(pos[:, 2] > 0.3 * grid[2], 1.0, 0.0).astype(np.float32)
    return dict(pos=pos, u=u, w=w, alive=w > 0)


@pytest.fixture
def same_particles(monkeypatch):
    """Both facades build the same numpy particles."""
    parts = _np_particles()
    monkeypatch.setattr(rfacade, "build_particles",
                        lambda spec: rpic.ParticleState(**{k: jnp.asarray(v) for k, v in parts.items()}))
    monkeypatch.setattr(tfacade, "build_particles", lambda spec, device=None: tpic.ParticleState(
        **{k: torch.from_numpy(v.copy()) for k, v in parts.items()}).to(device))
    return parts


def _lwfa(pkg, **kw):
    kw.setdefault("grid", GRID)
    kw.setdefault("ppc", 1)
    kw.setdefault("backend", "xla" if pkg is rapi else "torch")
    return pkg.scenario("lwfa", **kw)


def _leaves(params, **kw):
    return {k: v.detach().clone().to(**kw).requires_grad_() for k, v in params.items()}


def _port_value_and_grad(loss_fn, params):
    leaves = _leaves(params)
    loss, _ = loss_fn(leaves)
    loss.backward()
    return float(loss.detach()), {k: float(v.grad) for k, v in leaves.items()}


# -- permutations -----------------------------------------------------------------


def _vjp_ref(fn, values, *args, ct):
    _, vjp = jax.vjp(lambda v: fn(v, *args), jnp.asarray(values))
    return np.asarray(vjp(jnp.asarray(ct))[0])


def _vjp_port(fn, values, *args, ct):
    v = torch.from_numpy(values.copy()).requires_grad_()
    out = fn(v, *args)
    out.backward(torch.from_numpy(ct))
    return out.detach().numpy(), v.grad.numpy()


def test_permute_values_forward_and_vjp_match_reference():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(17, 3)).astype(np.float32)
    ct = rng.normal(size=(17, 3)).astype(np.float32)
    perm = rng.permutation(17)
    out, g = _vjp_port(tgrad.permute_values, v, torch.from_numpy(perm), ct=ct)
    np.testing.assert_array_equal(out, v[perm])
    np.testing.assert_array_equal(g, _vjp_ref(rgrad.permute_values, v, jnp.asarray(perm), ct=ct))
    # outside autograd the plain indexing runs, with the same bits
    np.testing.assert_array_equal(tgrad.permute_values(torch.from_numpy(v), torch.from_numpy(perm)).numpy(), v[perm])


def test_permute_tree_mixed_dtypes():
    """Float leaves through the autograd permutation, int and bool leaves
    indexed directly; every leaf bitwise-permuted, grads through the float
    leaf only, as the reference's."""
    rng = np.random.default_rng(1)
    perm = torch.from_numpy(rng.permutation(9))
    f = torch.from_numpy(rng.normal(size=(9, 2)).astype(np.float32)).requires_grad_()
    tree = {"f": f, "i": torch.arange(9, dtype=torch.int32), "b": torch.arange(9) % 2 == 0}
    out = tgrad.permute_tree(tree, perm)
    for k in tree:
        assert torch.equal(out[k], tree[k][perm]) and out[k].dtype == tree[k].dtype
    assert not out["i"].requires_grad and not out["b"].requires_grad
    torch.sum(out["f"] ** 2).backward()
    np.testing.assert_allclose(f.grad.numpy(), 2 * f.detach().numpy(), rtol=1e-6)
    particles = tpic.ParticleState(pos=f.detach()[:, :1].repeat(1, 3), u=f.detach()[:, :1].repeat(1, 3),
                                   w=f.detach()[:, 0], alive=tree["b"])
    moved = tgrad.permute_tree(particles, perm)
    assert all(torch.equal(getattr(moved, n), getattr(particles, n)[perm]) for n in ("pos", "u", "w", "alive"))


def test_slot_gather_masks_pads_like_reference():
    """Forward: the clamp-gather, pads aliasing particle 0, bit for bit.
    Backward: the reference's VJP; a pad slot puts nothing on particle 0,
    where the native indexing rule would."""
    rng = np.random.default_rng(2)
    vals = rng.normal(size=(10, 3)).astype(np.float32)
    ct = rng.normal(size=(2, 3, 3)).astype(np.float32)
    slots = np.array([[0, 3, -1], [9, -1, -1]], dtype=np.int32)
    out, g = _vjp_port(tgrad.slot_gather, vals, torch.from_numpy(slots), ct=ct)
    np.testing.assert_array_equal(out, vals[np.maximum(slots, 0)])
    np.testing.assert_array_equal(g, _vjp_ref(rgrad.slot_gather, vals, jnp.asarray(slots), ct=ct))
    np.testing.assert_array_equal(g[0], ct[0, 0])  # particle 0's only real slot
    v = torch.from_numpy(vals).requires_grad_()
    v[torch.clamp_min(torch.from_numpy(slots), 0).long()].backward(torch.from_numpy(ct))
    assert not np.allclose(v.grad.numpy(), g)  # the naive rule collects the pads
    # the core layer calls it under its old names
    from repro_torch.core import binning

    assert binning.slot_gather is tgrad.slot_gather and binning.permute_tree is tgrad.permute_tree


# -- the laser ----------------------------------------------------------------------


def _laser_f32_oracle(grid, spec):
    """The float32 pulse as the port computed it before the overrides."""
    nx, ny, nz = grid.shape
    f32 = torch.float32
    x = torch.arange(nx, dtype=f32)[:, None, None] + 0.5
    y = torch.arange(ny, dtype=f32)[None, :, None]
    z = torch.arange(nz, dtype=f32)[None, None, :]
    a0, waist, duration = (torch.tensor(v, dtype=f32) for v in (spec.a0, spec.waist, spec.duration))
    xr, yr = x - nx / 2, y - ny / 2
    r2 = xr * xr + yr * yr
    k0 = 2.0 * np.pi / spec.wavelength

    def pulse(zz):
        zr = (zz - spec.z_center) / duration
        return a0 * k0 * torch.exp(-r2 / (waist * waist) - zr * zr) * torch.cos(k0 * (zz - spec.z_center))

    return pulse(z), pulse(z + 0.5)


def test_inject_laser_overrides_match_reference():
    spec_t, spec_r = _lwfa(tapi), _lwfa(rapi)
    plain = tpic.inject_laser(tpic.FieldState.zeros(GRID), spec_t.grid, spec_t.laser)
    ex, by = _laser_f32_oracle(spec_t.grid, spec_t.laser)
    assert torch.equal(plain.ex, 0 + ex) and torch.equal(plain.by, 0 + by)  # no override: bits as before
    over = dict(a0=2.3, waist=5.1, duration=7.4)
    got = tpic.inject_laser(tpic.FieldState.zeros(GRID), spec_t.grid, spec_t.laser,
                            **{k: torch.tensor(v, requires_grad=True) for k, v in over.items()})
    want = ref_inject_laser(rpic.FieldState.zeros(GRID), spec_r.grid, spec_r.laser,
                            **{k: jnp.float32(v) for k, v in over.items()})
    for n in FIELDS:
        np.testing.assert_allclose(getattr(got, n).detach().numpy(), np.asarray(getattr(want, n)), rtol=1e-6,
                                   atol=1e-6 * float(np.abs(np.asarray(want.ex)).max()), err_msg=n)
    assert got.ex.requires_grad and got.ex.dtype == torch.float32
    f64 = tpic.inject_laser(tpic.FieldState.zeros(GRID, torch.float64), spec_t.grid, spec_t.laser)
    assert f64.ex.dtype == torch.float64


# -- the differentiable window ----------------------------------------------------------

SORTING = dict(sort_interval=4, min_sort_interval=3)  # policy sorts inside 8 steps


@pytest.mark.parametrize("remat", ["none", "step", "chunk"])
def test_run_window_diff_forward_bits_equal_windowed_run(remat, same_particles):
    """The diff window's forward is bit-identical to the windowed
    `Simulation` on backend torch — every state leaf, the policy state and
    the sort counters — under every remat policy, with policy sorts inside
    the window."""
    policy = SortPolicyConfig(**SORTING)
    spec = _lwfa(tapi, steps=8, window=8, policy=policy)
    sim = tapi.make_simulation(spec, device="cpu")
    state, pstate = sim.state, sim.policy_state
    got, got_p, bundle = run_window_diff(state, pstate, sim.config, 8, policy=policy, remat=remat,
                                         remat_chunk=4 if remat == "chunk" else 0)
    sim.run(8)
    assert bundle["n_done"] == 8 and bundle["halt_code"] == 0 and bundle["n_sorts"] >= 1
    assert (bundle["n_sorts"], bundle["n_rebuilds"]) == (sim.sorts, sim.rebuilds)
    assert int(bundle["per_step"]["sorted"].sum()) == sim.sorts + sim.rebuilds
    assert got.step == sim.state.step == 8
    for part in ("fields", "particles", "layout", "slab"):
        a, b = getattr(got, part), getattr(sim.state, part)
        for f in dataclasses.fields(a):
            assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f"{part}.{f.name}"
    for f in dataclasses.fields(got_p):
        assert torch.equal(getattr(got_p, f.name), getattr(sim.policy_state, f.name)), f.name


@pytest.mark.parametrize("backend", ["cuda", "cuda_reduced", "auto"])
def test_run_window_diff_refuses_kernel_backends(backend):
    spec = _lwfa(tapi)
    config = dataclasses.replace(tapi.pic_config(spec), backend=backend)
    state = tpic.init_state(tapi.build_fields(spec, device="cpu"), tapi.build_particles(spec, device="cpu"),
                            config)[0]
    with pytest.raises(ValueError, match="torch.*xla.*no VJP"):
        run_window_diff(state, policy_init(), config, 4)
    with pytest.raises(ValueError, match="remat_chunk"):
        run_window_diff(state, policy_init(), dataclasses.replace(config, backend="xla"), 4, remat="chunk",
                        remat_chunk=3)


def test_grads_match_jax_grad_of_reference(same_particles):
    """Acceptance: every learnable leaf, 20 steps, float64 on both sides:
    the port's grads within rtol 1e-6 of `jax.grad` of the reference's
    `make_objective`; in float32 the losses within rtol 2e-5."""
    learn = tuple(sorted(rgrad.LEARNABLE))
    kw = dict(learn=learn, steps=20, objective_kwargs={"e_min": 0.1})
    with jax.enable_x64(True):
        loss_r, params_r = rgrad.make_objective(_lwfa(rapi), dtype=jnp.float64, **kw)
        (value_r, _), grads_r = jax.value_and_grad(loss_r, has_aux=True)(params_r)
    loss_t, params_t = tgrad.make_objective(_lwfa(tapi), dtype=torch.float64, device="cpu", **kw)
    value_t, grads_t = _port_value_and_grad(loss_t, params_t)
    assert set(grads_t) == set(learn)
    np.testing.assert_allclose(value_t, float(value_r), rtol=1e-6)
    for name in learn:
        assert grads_t[name] != 0.0
        np.testing.assert_allclose(grads_t[name], float(grads_r[name]), rtol=1e-6, err_msg=name)
    loss_r32, params_r32 = rgrad.make_objective(_lwfa(rapi), **kw)
    loss_t32, params_t32 = tgrad.make_objective(_lwfa(tapi), device="cpu", **kw)
    with torch.no_grad():
        value_t32 = float(loss_t32(params_t32)[0])
    np.testing.assert_allclose(value_t32, float(loss_r32(params_r32)[0]), rtol=2e-5)


@pytest.mark.parametrize("order", [1, 2, 3])
def test_grad_matches_central_fd_per_order(order, same_particles):
    """Autograd through a short lwfa window matches central finite
    differences in float64 at every deposition order (tests/test_grad.py's
    check, on the port)."""
    loss_fn, params = tgrad.make_objective(_lwfa(tapi, order=order), learn=("laser.a0", "density"), steps=4,
                                           objective_kwargs={"e_min": 0.1}, dtype=torch.float64, device="cpu")
    _, grads = _port_value_and_grad(loss_fn, params)

    def value(p):
        with torch.no_grad():
            return float(loss_fn(p)[0])

    for name, v in params.items():
        eps = 1e-4 * max(1.0, abs(float(v)))
        up = value({**params, name: v + eps})
        dn = value({**params, name: v - eps})
        fd = (up - dn) / (2 * eps)
        assert np.isfinite(fd) and fd != 0.0, f"degenerate FD for {name}"
        np.testing.assert_allclose(grads[name], fd, rtol=1e-3, err_msg=f"order={order} param={name}")


def test_remat_bounds_saved_bytes(same_particles):
    """The bytes autograd saves for the backward (counted through
    `saved_tensors_hooks`, each storage once): under remat="step" the same
    at 4 and 8 steps — a checkpoint keeps only its input state, which
    `torch.utils.checkpoint` holds outside the hooks — and under half of
    remat="none"'s at 8 steps; the three policies' float64 grads equal."""

    def run(remat, n):
        loss_fn, params = tgrad.make_objective(_lwfa(tapi), learn=("laser.a0", "density"), steps=n, remat=remat,
                                               remat_chunk=4, objective_kwargs={"e_min": 0.1},
                                               dtype=torch.float64, device="cpu")
        leaves = _leaves(params)
        storages = {}

        def pack(t):
            storages[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _ = loss_fn(leaves)
        loss.backward()
        return sum(storages.values()), {k: float(v.grad) for k, v in leaves.items()}

    step4, _ = run("step", 4)
    step8, g_step = run("step", 8)
    none8, g_none = run("none", 8)
    _, g_chunk = run("chunk", 8)
    assert step4 == step8
    assert 2 * step8 < none8
    assert g_step == g_none == g_chunk


# -- parameters, objectives, GradSpec ------------------------------------------------------


def test_param_mapping_and_aliases():
    assert tgrad.resolve_param("laser.w0") == "laser.waist"
    assert tgrad.resolve_param("laser.tau") == "laser.duration"
    assert tgrad.LEARNABLE == rgrad.LEARNABLE
    with pytest.raises(KeyError, match="unknown trainable"):
        tgrad.resolve_param("laser.phase")
    spec = _lwfa(tapi)
    p = tgrad.default_params(spec, ("laser.a0", "laser.tau", "density"))
    assert list(p) == ["laser.a0", "laser.duration", "density"]
    assert float(p["laser.a0"]) == spec.laser.a0 and float(p["density"]) == spec.plasma.density
    assert p["density"].dtype == torch.float32
    with pytest.raises(ValueError, match="laser"):
        tgrad.default_params(tapi.scenario("uniform"), ("laser.a0",))


def test_state_builder_applies_params_and_shares_index_machinery(same_particles):
    """`build` scales Ex and By with a0 and the weights with the density;
    the bins and slab are the builder's, untouched; the state at the
    spec's values is the spec-built one bit for bit."""
    spec = _lwfa(tapi)
    builder = StateBuilder(spec, tapi.pic_config(spec), device="cpu")
    s1 = builder.build({"laser.a0": torch.tensor(2.0), "density": torch.tensor(spec.plasma.density)})
    s2 = builder.build({"laser.a0": 2.5, "density": 2 * spec.plasma.density})
    torch.testing.assert_close(s2.fields.ex, s1.fields.ex * 1.25, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(s2.fields.by, s1.fields.by * 1.25, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(s2.particles.w, s1.particles.w * 2.0)
    assert s1.layout is s2.layout and s1.slab is s2.slab
    sim = tapi.make_simulation(spec, device="cpu")
    for n in FIELDS:
        assert torch.equal(getattr(s1.fields, n), getattr(sim.state.fields, n)), n
    assert torch.equal(s1.particles.w, sim.state.particles.w)
    assert torch.equal(s1.layout.slots, sim.state.layout.slots)


def test_objective_registry_matches_reference():
    names = tgrad.objective_names()
    assert names == rgrad.objective_names()
    for name in names:
        assert tgrad.get_objective(name).maximize == rgrad.get_objective(name).maximize
    with pytest.raises(KeyError, match="unknown objective"):
        tgrad.get_objective("nope")


@pytest.mark.parametrize("name,kw", [("injected_charge", {"e_min": 0.1}), ("injected_charge", {}),
                                     ("mean_beam_energy", {"e_min": 0.05, "width": 0.02}),
                                     ("field_energy_band", {"z0": 4.0, "z1": 15.0}), ("field_energy_band", {})])
def test_objectives_match_reference_on_one_state(name, kw):
    """Each shipped objective on the same float32 state (hot momenta, so
    the gate is open on a share of the particles, and a field in every
    component) within rtol 1e-6 of the reference's."""
    rng = np.random.default_rng(3)
    parts = _np_particles(u_thermal=1.2, seed=4)
    fields = {n: rng.normal(size=GRID).astype(np.float32) for n in FIELDS}
    cfg_r, cfg_t = rapi.pic_config(_lwfa(rapi)), tapi.pic_config(_lwfa(tapi))
    st_r = rpic.PICState(fields=rpic.FieldState(**{n: jnp.asarray(v) for n, v in fields.items()}),
                         particles=rpic.ParticleState(**{k: jnp.asarray(v) for k, v in parts.items()}),
                         layout=None, step=0)
    st_t = tpic.PICState(fields=tpic.FieldState(**{n: torch.from_numpy(v) for n, v in fields.items()}),
                         particles=tpic.ParticleState(**{k: torch.from_numpy(v) for k, v in parts.items()}),
                         layout=None, step=0)
    want = float(rgrad.get_objective(name).fn(st_r, {}, cfg_r, **kw))
    got = tgrad.get_objective(name).fn(st_t, {}, cfg_t, **kw)
    assert got.dtype == torch.float32 and want != 0.0
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_gradspec_validation_and_json_both_ways():
    gs = tgrad.GradSpec(learn=("laser.w0", "density"), remat="chunk", remat_chunk=4,
                        objective_kwargs={"e_min": 0.2})
    assert gs.learn == ("laser.waist", "density")
    assert gs.okwargs == {"e_min": 0.2}
    assert tgrad.GradSpec.from_dict(gs.to_dict()) == gs
    assert tapi.GradSpec is tgrad.GradSpec
    with pytest.raises(ValueError):
        tgrad.GradSpec(remat="everything")
    with pytest.raises((ValueError, KeyError)):
        tgrad.GradSpec(learn=())
    with pytest.raises(KeyError):
        tgrad.GradSpec(learn=("laser.phase",))
    # the port's dump loads in the reference, and the reference's in the port
    ref = rgrad.GradSpec.from_dict(gs.to_dict())
    assert ref.to_dict() == gs.to_dict()
    back = rgrad.GradSpec(objective="field_energy_band", learn=("laser.tau",), steps=12, remat="none",
                          objective_kwargs={"z0": 3.0})
    assert tgrad.GradSpec.from_dict(back.to_dict()).to_dict() == back.to_dict()
