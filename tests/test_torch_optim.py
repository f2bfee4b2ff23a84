"""Port parity of the optimizer and the fit (`repro_torch.optim`,
`repro_torch.grad.fit`, `repro_torch.checkpoint.CheckpointManager`,
`repro_torch.launch.pic_fit`) against `repro.optim` and `repro.grad.fit`.

AdamW: one update against the reference's on the same numpy values, and
tests/test_optim.py's cases (a quadratic, decoupled decay, clipping, the
schedule). The fit: both packages on the same numpy particles (each
facade's `build_particles` replaced), lwfa 6x6x24, ppc 1, 6 steps, 3
iterations; a resumed fit against an uninterrupted one; fit checkpoints
carried from one package to the other, both ways.

Tolerances: one AdamW update rtol 1e-6 (float32 arithmetic in both); the
fit's parameters rtol 1e-4 of the reference's at every iteration (the
gradients agree to ~1e-6 and AdamW normalizes them); a resumed fit equal
to the uninterrupted one exactly.
"""

import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.api as rapi  # noqa: E402
import repro.api.facade as rfacade  # noqa: E402
import repro.optim as roptim  # noqa: E402
import repro.pic as rpic  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
import repro_torch.api.facade as tfacade  # noqa: E402
import repro_torch.optim as toptim  # noqa: E402
import repro_torch.pic as tpic  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.launch import pic_fit  # noqa: E402

GRID = (6, 6, 24)
FIT = dict(learn=("laser.a0",), steps=6, objective_kwargs={"e_min": 0.1})


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- AdamW ------------------------------------------------------------------------------


def test_adamw_update_matches_reference():
    """One clipped update from a warm optimizer state (count 3), float32
    params and a float64 one, nested dicts: params, moments, count and the
    grad norm as the reference's."""
    rng = np.random.default_rng(0)
    shapes = {"a": (3,), "b": {"c": (2, 2), "d": ()}}

    def tree(fn, s=shapes):
        return {k: tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in s.items()}

    params = tree(lambda s: rng.normal(size=s).astype(np.float32))
    params["b"]["d"] = np.asarray(1.7, np.float64)
    grads = tree(lambda s: 3.0 * rng.normal(size=s).astype(np.float32))
    mu = tree(lambda s: rng.normal(size=s).astype(np.float32))
    nu = tree(lambda s: rng.random(size=s).astype(np.float32))
    cfg = dict(lr=0.01, b1=0.8, b2=0.9, eps=1e-6, weight_decay=0.05, grad_clip=1.5)

    def to(fn, t):
        return {k: to(fn, v) if isinstance(v, dict) else fn(v) for k, v in t.items()}

    with jax.enable_x64(True):
        rp, rs, rm = roptim.adamw_update(to(jnp.asarray, grads), {"mu": to(jnp.asarray, mu), "nu": to(jnp.asarray, nu),
                                         "count": jnp.asarray(3, jnp.int32)}, to(jnp.asarray, params),
                                         roptim.AdamWConfig(**cfg), lr_scale=0.5)
    tt = lambda a: torch.from_numpy(np.array(a))
    tp, ts, tm = toptim.adamw_update(to(tt, grads), {"mu": to(tt, mu), "nu": to(tt, nu),
                                     "count": torch.tensor(3, dtype=torch.int32)}, to(tt, params),
                                     toptim.AdamWConfig(**cfg), lr_scale=0.5)
    flat = lambda t: [x for k in sorted(t) for x in (flat(t[k]) if isinstance(t[k], dict) else [t[k]])]
    for a, b in zip(flat(tp) + flat(ts["mu"]) + flat(ts["nu"]), flat(rp) + flat(rs["mu"]) + flat(rs["nu"])):
        assert str(a.dtype).removeprefix("torch.") == str(np.asarray(b).dtype)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    assert int(ts["count"]) == int(rs["count"]) == 4 and ts["count"].dtype == torch.int32
    np.testing.assert_allclose(float(tm["grad_norm"]), float(rm["grad_norm"]), rtol=1e-6)


def test_adamw_descends_a_quadratic():
    target = torch.tensor([1.0, -2.0, 0.5])
    params = {"x": torch.zeros(3)}
    opt = toptim.adamw_init(params)
    assert opt["mu"]["x"].dtype == torch.float32 and set(opt) == {"mu", "nu", "count"}
    cfg = toptim.AdamWConfig(lr=0.1, weight_decay=0.0)
    losses = []
    for _ in range(30):
        x = params["x"].clone().requires_grad_()
        loss = torch.sum((x - target) ** 2)
        loss.backward()
        losses.append(float(loss.detach()))
        params, opt, metrics = toptim.adamw_update({"x": x.grad}, opt, params, cfg)
        assert float(metrics["grad_norm"]) >= 0.0
    assert losses[-1] < 0.05 * losses[0]
    assert int(opt["count"]) == 30


def test_adamw_weight_decay_is_decoupled():
    params = {"x": torch.tensor([4.0])}
    new, _, _ = toptim.adamw_update({"x": torch.zeros(1)}, toptim.adamw_init(params), params,
                                    toptim.AdamWConfig(lr=0.1, weight_decay=0.5))
    assert float(new["x"][0]) < 4.0


def test_clip_by_global_norm():
    grads = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    np.testing.assert_allclose(float(toptim.global_norm(grads)), 5.0, rtol=1e-6)
    clipped, norm = toptim.clip_by_global_norm(grads, 1.0)
    np.testing.assert_allclose(float(norm), 5.0, rtol=1e-6)
    np.testing.assert_allclose(float(toptim.global_norm(clipped)), 1.0, rtol=1e-5)
    small, _ = toptim.clip_by_global_norm({"a": torch.tensor([0.3])}, 1.0)
    np.testing.assert_allclose(small["a"].numpy(), [0.3], rtol=1e-6)


def test_lr_schedule_matches_reference():
    cfg = toptim.ScheduleConfig(warmup_steps=10, total_steps=100, min_ratio=0.1)
    rcfg = roptim.ScheduleConfig(warmup_steps=10, total_steps=100, min_ratio=0.1)
    assert float(toptim.lr_schedule(0, cfg)) == 0.0
    assert float(toptim.lr_schedule(5, cfg)) == 0.5
    np.testing.assert_allclose(float(toptim.lr_schedule(100, cfg)), 0.1, rtol=1e-5)
    for step in (0, 3, 10, 37, 55, 100, 140):
        np.testing.assert_allclose(float(toptim.lr_schedule(torch.tensor(step), cfg)),
                                   float(roptim.lr_schedule(step, rcfg)), rtol=1e-6, atol=1e-7)


# -- the fit ------------------------------------------------------------------------------


@pytest.fixture
def same_particles(monkeypatch):
    """Both facades build lwfa's ppc-1 plasma from the same numpy arrays."""
    rng = np.random.default_rng(0)
    cells = np.stack(np.meshgrid(*(np.arange(n) for n in GRID), indexing="ij"), -1).reshape(-1, 3)
    pos = (cells + 0.5).astype(np.float32)
    w = np.where(pos[:, 2] > 0.3 * GRID[2], 1.0, 0.0).astype(np.float32)
    parts = dict(pos=pos, u=(0.01 * rng.normal(size=pos.shape)).astype(np.float32), w=w, alive=w > 0)
    monkeypatch.setattr(rfacade, "build_particles",
                        lambda spec: rpic.ParticleState(**{k: jnp.asarray(v) for k, v in parts.items()}))
    monkeypatch.setattr(tfacade, "build_particles", lambda spec, device=None: tpic.ParticleState(
        **{k: torch.from_numpy(v.copy()) for k, v in parts.items()}).to(device))


def _spec(pkg):
    return pkg.scenario("lwfa", grid=GRID, ppc=1, backend="xla" if pkg is rapi else "torch")


def _fit_t(iters, **kw):
    return tapi.fit_simulation(_spec(tapi), iters=iters, device="cpu", **FIT, **kw)


def _crash_after(directory, step):
    """Leave the checkpoints a fit killed after iteration ``step`` would:
    the later ones removed, LATEST naming ``step``."""
    for name in os.listdir(directory):
        if name.startswith("step_") and int(name[5:]) > step:
            shutil.rmtree(os.path.join(directory, name))
    with open(os.path.join(directory, "LATEST"), "w") as f:
        f.write(str(step))


def test_fit_matches_reference_and_checkpoints_cross_packages(same_particles, tmp_path):
    """Acceptance: 3 AdamW iterations lower the loss with one set-up and
    every gradient finite; the port's params follow the reference's within
    rtol 1e-4 at every iteration. A reference fit checkpointed after
    iteration 2 resumes in the port, and a port fit checkpointed after
    iteration 2 resumes in the reference, each ending where the
    uninterrupted fits end."""
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref = rapi.fit_simulation(_spec(rapi), iters=3, checkpoint_dir=str(ref_dir), keep=3, **FIT)
    port = _fit_t(3, checkpoint_dir=str(port_dir), keep=3)
    assert port.compiles == 1
    losses = [r["loss"] for r in port.history]
    assert losses[-1] < losses[0]
    for r in port.history:
        assert all(np.isfinite(g) for g in r["grads"].values()) and np.isfinite(r["grad_norm"])
    for r_t, r_r in zip(port.history, ref.history):
        np.testing.assert_allclose(r_t["params"]["laser.a0"], r_r["params"]["laser.a0"], rtol=1e-4)
        np.testing.assert_allclose(r_t["loss"], r_r["loss"], rtol=2e-5)
        np.testing.assert_allclose(r_t["grads"]["laser.a0"], r_r["grads"]["laser.a0"], rtol=1e-3)
    np.testing.assert_allclose(port.params["laser.a0"], ref.params["laser.a0"], rtol=1e-4)

    _crash_after(ref_dir, 2)
    into_port = _fit_t(3, checkpoint_dir=str(ref_dir))
    assert [r["iter"] for r in into_port.history] == [2]
    assert into_port.history[0]["params"] == ref.history[2]["params"]  # restored bit for bit
    np.testing.assert_allclose(into_port.params["laser.a0"], ref.params["laser.a0"], rtol=1e-4)

    _crash_after(port_dir, 2)
    into_ref = rapi.fit_simulation(_spec(rapi), iters=3, checkpoint_dir=str(port_dir), **FIT)
    assert [r["iter"] for r in into_ref.history] == [2]
    assert into_ref.history[0]["params"] == port.history[2]["params"]
    np.testing.assert_allclose(into_ref.params["laser.a0"], port.params["laser.a0"], rtol=1e-4)


def test_fit_resume_equals_uninterrupted(same_particles, tmp_path):
    """A fit stopped after 2 of 4 iterations and run again with the same
    checkpoint directory continues the same trajectory, bit for bit."""
    whole = _fit_t(4)
    first = _fit_t(2, checkpoint_dir=str(tmp_path / "fit"))
    assert [r["iter"] for r in first.history] == [0, 1]
    resumed = _fit_t(4, checkpoint_dir=str(tmp_path / "fit"))
    assert [r["iter"] for r in resumed.history] == [2, 3]
    assert first.history + resumed.history == whole.history
    assert resumed.params == whole.params
    manager = CheckpointManager(str(tmp_path / "fit"), keep=2)
    assert manager.all_steps() == [3, 4] and manager.latest_step() == 4
    tree, step = manager.restore({"params": {"laser.a0": torch.zeros(())},
                                  "opt": toptim.adamw_init({"laser.a0": torch.zeros(())})})
    assert step == 4 and int(tree["opt"]["count"]) == 4
    assert float(tree["params"]["laser.a0"]) == whole.params["laser.a0"]


def test_fit_refuses_chunk_that_does_not_divide():
    with pytest.raises(ValueError, match="chunk"):
        tapi.make_objective(_spec(tapi), learn=("laser.a0",), steps=6, remat="chunk", remat_chunk=4, device="cpu")


def test_pic_fit_smoke_on_cpu(capsys):
    assert pic_fit.main(["--smoke", "--device", "cpu"]) == 0
    assert "-> OK" in capsys.readouterr().out
