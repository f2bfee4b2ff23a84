"""The port's API layer and entry points: scenarios and overrides against the
reference registry, initial conditions (laser fields, plasma structure),
the device rule of the entry points, the launcher on the CPU, and the rule
that the port imports neither JAX nor `repro`.
"""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as rapi  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
from repro_torch.launch import pic_run  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FIELDS = ("ex", "ey", "ez", "bx", "by", "bz")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plain(obj):
    """A spec node as nested plain values, for comparing the two packages."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (tuple, list)):
        return [_plain(v) for v in obj]
    return obj


@pytest.mark.parametrize(
    "name,overrides",
    [
        ("uniform", {}),
        ("uniform", dict(grid=(128, 128, 128), ppc=2, order=3, steps=32, window=16)),
        ("lwfa", {}),
        ("lwfa", dict(grid=(4, 4, 32), order=2, capacity=64, seed=3, u_thermal=0.02)),
    ],
)
def test_scenarios_match_reference(name, overrides):
    spec_t = tapi.scenario(name, **overrides)
    spec_r = rapi.scenario(name, **overrides)
    for node in ("grid", "plasma", "laser", "run", "mesh", "comm", "health", "fault"):
        assert _plain(getattr(spec_t, node)) == _plain(getattr(spec_r, node)), node
    assert spec_t.dt == spec_r.dt
    assert (spec_t.sort.capacity, spec_t.sort.mode) == (spec_r.sort.capacity, spec_r.sort.mode)
    assert _plain(spec_t.sort.policy) == _plain(spec_r.sort.policy)
    assert (spec_t.deposition.order, spec_t.deposition.mode) == (spec_r.deposition.order, spec_r.deposition.mode)
    cfg_t, cfg_r = tapi.pic_config(spec_t), rapi.pic_config(spec_r)
    for f in ("dt", "order", "capacity", "charge", "mass", "ckc_beta", "deposition", "gather", "sort_mode"):
        assert getattr(cfg_t, f) == getattr(cfg_r, f), f


def test_overrides_map_reference_backend_names_and_reject_unported():
    assert tapi.scenario("uniform", backend="pallas_reduced").deposition.backend == "cuda_reduced"
    assert tapi.scenario("uniform", backend="xla").deposition.backend == "torch"
    assert tapi.scenario("uniform", backend="pallas").to_dict()["deposition"]["backend"] == "pallas"
    # a mesh selects the distributed driver, as in the reference
    assert tapi.scenario("uniform", mesh="2x2").to_json() == rapi.scenario("uniform", mesh="2x2").to_json()
    with pytest.raises(TypeError):
        tapi.scenario("uniform", meshes="2x2")
    with pytest.raises(ValueError):
        tapi.scenario("uniform", deposition="cic")
    with pytest.raises(ValueError):
        tapi.scenario("uniform", sort="bucket")
    assert tapi.scenario("uniform", sort="global").sort.mode == "global"
    with pytest.raises(KeyError):
        tapi.scenario("ion_acoustic")


@pytest.mark.parametrize("mode", ["matrix", "matrix_unfused", "scatter", "rhocell"])
@pytest.mark.parametrize("gather", ["", "matrix", "matrix_unfused", "scatter"])
def test_deposition_modes_resolve_as_the_reference(mode, gather):
    """Every deposition x gather pair the reference accepts: the same
    resolved gather (by default ``scatter`` beside a scatter or rhocell
    deposition) and the same step configuration."""
    spec_t = tapi.scenario("uniform", deposition=mode, gather=gather)
    spec_r = rapi.scenario("uniform", deposition=mode, gather=gather)
    assert spec_t.deposition.resolved_gather == spec_r.deposition.resolved_gather
    cfg_t, cfg_r = tapi.pic_config(spec_t), rapi.pic_config(spec_r)
    assert (cfg_t.deposition, cfg_t.gather) == (cfg_r.deposition, cfg_r.gather)
    assert (cfg_t.needs_bins, cfg_t.needs_slab) == (cfg_r.needs_bins, cfg_r.needs_slab)


def test_laser_fields_match_reference():
    spec_t, spec_r = tapi.scenario("lwfa"), rapi.scenario("lwfa")
    ft, fr = tapi.build_fields(spec_t, device="cpu"), rapi.build_fields(spec_r)
    for n in FIELDS:
        np.testing.assert_allclose(getattr(ft, n).numpy(), np.asarray(getattr(fr, n)), rtol=1e-5, atol=1e-5, err_msg=n)
    assert float(ft.ex.abs().max()) > 1.0


@pytest.mark.parametrize("name", ["uniform", "lwfa"])
def test_particles_match_reference_structure(name):
    """Positions, weights and alive flags are deterministic and must match;
    momenta come from different generators and match only in spread."""
    spec_t, spec_r = tapi.scenario(name, grid=(4, 4, 16)), rapi.scenario(name, grid=(4, 4, 16))
    pt, pr = tapi.build_particles(spec_t, device="cpu"), rapi.build_particles(spec_r)
    np.testing.assert_allclose(pt.pos.numpy(), np.asarray(pr.pos), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(pt.w.numpy(), np.asarray(pr.w))
    np.testing.assert_array_equal(pt.alive.numpy(), np.asarray(pr.alive))
    if name == "lwfa":
        assert 0 < int(pt.alive.sum()) < pt.n
    spread_t, spread_r = float(pt.u.std()), float(np.asarray(pr.u).std())
    assert abs(spread_t - spread_r) < 0.25 * spread_r
    again = tapi.build_particles(spec_t, device="cpu")
    assert torch.equal(again.u, pt.u), "one seed must give one plasma"


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without a CUDA device")
    spec = tapi.scenario("uniform", grid=(4, 4, 4))
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.make_simulation(spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.build_particles(spec)
    sim = tapi.make_simulation(spec, device="cpu")
    assert sim.device.type == "cpu"
    sim.run(2, window=None)  # the host-driven loop
    assert sim.state.step == 2 and sim.windows == 0


def test_pic_run_cli_on_cpu(capsys):
    pic_run.main(["--scenario", "uniform", "--device", "cpu", "--grid", "4", "4", "4",
                  "--steps", "4", "--window", "2", "--order", "2"])
    out = capsys.readouterr().out
    assert "particle-steps/s" in out and "energies: field=" in out
    assert "host reads/window=" in out


def test_pic_run_deprecated_flags_resolve_as_the_reference(tmp_path, capsys):
    """``--workload`` is ``--scenario`` with a note, ``--use-pallas`` is
    ``--backend pallas``: the same SimSpec, written and not run."""
    with pytest.warns(DeprecationWarning, match="use_pallas"):
        pic_run.main(["--workload", "lwfa", "--use-pallas", "--grid", "8", "8", "64", "--dump-spec",
                      str(tmp_path / "old.json")])
    assert "note: --workload is deprecated, use --scenario" in capsys.readouterr().out
    pic_run.main(["--scenario", "lwfa", "--backend", "pallas", "--grid", "8", "8", "64", "--dump-spec",
                  str(tmp_path / "new.json")])
    old, new = (tapi.SimSpec.from_json((tmp_path / f"{n}.json").read_text()) for n in ("old", "new"))
    assert old == new and old.name == "lwfa" and old.deposition.backend == "cuda"
    with pytest.raises(SystemExit):
        pic_run.main(["--workload", "uniform", "--spec", str(tmp_path / "new.json")])
    assert "--scenario/--workload and --spec are mutually exclusive" in capsys.readouterr().err


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20 and files[-1].exists()
    bad = {}
    for path in files:
        hits = {m for m in _imports(path) if m.split(".")[0] in ("jax", "jaxlib", "repro")}
        if hits:
            bad[str(path.relative_to(ROOT))] = sorted(hits)
    assert not bad, f"the port must not import JAX or repro: {bad}"


def test_counter_streaming_plasma_matches_reference():
    """Without thermal noise no random number is drawn: the two beams'
    positions, momenta and weights are the reference's exactly."""
    import jax

    import repro.pic as rpic
    import repro_torch.pic as tpic

    kw = dict(ppc_each_dim=(1, 1, 4), density=0.5, u_drift=0.15, drift_axis=1)
    ref = rpic.counter_streaming_plasma(jax.random.PRNGKey(0), rpic.GridSpec(shape=(2, 3, 4)), **kw)
    port = tpic.counter_streaming_plasma(torch.Generator().manual_seed(0), tpic.GridSpec(shape=(2, 3, 4)),
                                         device="cpu", **kw)
    for name in ("pos", "u", "w", "alive"):
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name)


def test_sim_driver_protocol():
    """`SimDriver` names what the reference's protocol names, and both of
    `make_simulation`'s drivers (single device, and a mesh) provide it."""
    names = lambda proto: {n for n in vars(proto) if not n.startswith("_")} | set(proto.__annotations__)
    assert names(tapi.SimDriver) == names(rapi.SimDriver)
    spec = tapi.scenario("uniform", grid=(4, 4, 4), ppc=1, steps=2, window=2)
    assert isinstance(tapi.make_simulation(spec, device="cpu"), tapi.SimDriver)
    assert isinstance(tapi.make_simulation(tapi.apply_overrides(spec, mesh=(2, 2)), device="cpu"), tapi.SimDriver)
    assert not isinstance(object(), tapi.SimDriver)
