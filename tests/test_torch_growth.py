"""The growth anchors of the docs/ensemble.md sweep: `two_stream` at its
registry size, drift 0.1, 0.2 and 0.3, 300 steps.

The port runs each drift against the reference given the same explicit
`DriftSpec`, and both run against `two_stream_linear_energy`, the cold
linear solution of the seed. The fitted growth meets the seeded mode's
analytic rate only where the growing root rules the fit's window, as it
does in the linear solution at drift 0.2. At 0.1 and 0.3 the window opens
on the velocity seed's transient, in the linear solution as well. Near the
cutoff (drift 0.3) the default time step adds growth, and a quarter of it
follows the linear solution."""

import dataclasses

import numpy as np
import pytest
import torch

import repro.api as rapi
import repro_torch.api as tapi

WINDOW = (0.75, 1.25)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec(api, drift, **overrides):
    return api.apply_overrides(api.scenario("two_stream"), drift=api.DriftSpec(u=drift, axis=2), **overrides)


def _energies(history):
    return np.array([h["step"] for h in history]), np.array([h["field_energy"] for h in history])


def _fitted_ratio(spec, steps, e):
    """The scenario tests' fit (tests/test_scenarios.py): d ln W/dt past
    100x the smallest energy and before 10% of the largest, over 2*gamma."""
    t = steps * spec.dt
    idx = np.where((e > 100 * e.min()) & (e < 0.1 * e.max()))[0]
    assert len(idx) >= 10
    return np.polyfit(t[idx[0]:idx[-1] + 1], np.log(e[idx[0]:idx[-1] + 1]), 1)[0] / (2 * tapi.two_stream_growth_rate(spec))


def _deviation(e, lin, block):
    """log10 of the measured over the linear energy, in block means over
    the linear phase (every sample below 10% of the run's largest)."""
    return np.array([np.log10(e[j:j + block].mean() / lin[j:j + block].mean())
                     for j in range(0, len(e), block) if (e[j:j + block] < 0.1 * e.max()).all()])


@pytest.mark.parametrize("drift", [0.1, 0.2, 0.3])
def test_two_stream_drift_follows_the_reference_and_the_linear_solution(drift):
    tspec, rspec = _spec(tapi, drift), _spec(rapi, drift)
    sim = tapi.make_simulation(tspec, device="cpu")
    sim.run()
    ref = rapi.make_simulation(rspec)
    ref.run()
    steps, e = _energies(sim.history)
    ref_steps, ref_e = _energies(ref.history)
    np.testing.assert_array_equal(steps, ref_steps)
    assert len(e) == 300 and np.isfinite(e).all()

    block = tspec.run.window
    ratio, ref_ratio = _fitted_ratio(tspec, steps, e), _fitted_ratio(tspec, steps, ref_e)
    assert ratio == pytest.approx(ref_ratio, rel=1e-2)
    np.testing.assert_allclose(_deviation(e, ref_e, block), 0.0, atol=np.log10(1.01))

    # both packages follow the linear solution of the seed within 0.5 decades
    lin = tapi.two_stream_linear_energy(tspec, steps)
    for energies in (e, ref_e):
        dev = _deviation(energies, lin, block)
        assert len(dev) >= 6 and np.abs(dev).max() < 0.5, dev

    # the fit finds the analytic rate exactly where it finds it in the
    # linear solution: at drift 0.2, not at 0.1 or 0.3
    lin_ratio = _fitted_ratio(tspec, steps, lin)
    assert (WINDOW[0] < lin_ratio < WINDOW[1]) == (drift == 0.2)
    if WINDOW[0] < lin_ratio < WINDOW[1]:
        assert WINDOW[0] < ratio < WINDOW[1]

    # the seeded mode rules the field to the end: no faster mode takes over
    ez = sim.state.fields.ez.double().mean(dim=(0, 1))
    spectrum = torch.fft.rfft(ez).abs()[1:]
    assert int(torch.argmax(spectrum)) + 1 == tspec.plasma.perturb.mode


def test_two_stream_time_step_error_near_the_cutoff():
    """Drift 0.3 seeds mode 4 near its cutoff, where the rate is most
    sensitive: at the default time step the field runs ahead of the linear
    solution, at a quarter of it the field follows the solution."""
    spec = _spec(tapi, 0.3)
    runs = {}
    for scale in (1, 4):
        s = tapi.apply_overrides(spec, dt=spec.dt / scale, steps=spec.run.steps * scale)
        sim = tapi.make_simulation(s, device="cpu")
        sim.run()
        steps, e = _energies(sim.history)
        runs[scale] = _deviation(e, tapi.two_stream_linear_energy(s, steps), s.run.window * scale)
    assert runs[1].max() > 0.1
    assert np.abs(runs[4]).max() < 0.05
    assert np.abs(runs[4]).max() < runs[1][: len(runs[4])].max() / 3


def test_two_stream_linear_energy_grows_at_the_analytic_rate_late():
    """Once the growing root rules (drift 0.2, t > 30), the linear
    solution's energy e-folds at 2*gamma; before any step it is 0."""
    spec = _spec(tapi, 0.2)
    gamma = tapi.two_stream_growth_rate(spec)
    steps = np.arange(int(30 / spec.dt), int(40 / spec.dt))
    w = tapi.two_stream_linear_energy(spec, steps)
    slope = np.polyfit(steps * spec.dt, np.log(w), 1)[0]
    assert slope == pytest.approx(2 * gamma, rel=1e-3)
    assert tapi.two_stream_linear_energy(spec, [0])[0] == pytest.approx(0.0, abs=1e-20)
    doubled = dataclasses.replace(spec, plasma=dataclasses.replace(
        spec.plasma, perturb=dataclasses.replace(spec.plasma.perturb, amplitude=2 * spec.plasma.perturb.amplitude)))
    np.testing.assert_allclose(tapi.two_stream_linear_energy(doubled, steps), 4 * w, rtol=1e-9)
