"""Trainable parameters: declared `SimSpec` leaves <-> a flat dict of 0-d
tensors. Counterpart of `repro.grad.params`.

`LEARNABLE` names the SimSpec leaves the gradient subsystem can
differentiate. `StateBuilder` splits the state's construction in two: the
eager, parameter-independent part (particles, global sort, bins, slab: the
index machinery, which carries no gradient) runs once, and `build(params)`
applies the parameters (the laser with tensor overrides, the density scale
on the weights) as tensor arithmetic, so that

* ``backward()`` reaches every learned leaf, and
* an optimizer step changes values only: the problem is set up once a fit.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["LEARNABLE", "StateBuilder", "default_params", "resolve_param"]

# canonical name -> human description (the CLI menu); aliases below
LEARNABLE = {
    "laser.a0": "laser amplitude a0",
    "laser.waist": "laser transverse 1/e radius w0 (grid units)",
    "laser.duration": "laser longitudinal 1/e half-length tau (grid units)",
    "density": "plasma density scale (multiplies every macro-weight)",
}

_ALIASES = {
    "laser.w0": "laser.waist",
    "laser.tau": "laser.duration",
}


def resolve_param(name: str) -> str:
    """Canonical LEARNABLE key for ``name`` (accepts the paper-notation
    aliases ``laser.w0``/``laser.tau``); KeyError otherwise."""
    name = _ALIASES.get(name, name)
    if name not in LEARNABLE:
        raise KeyError(
            f"unknown trainable parameter {name!r}; learnable: {sorted(LEARNABLE)} (aliases: {sorted(_ALIASES)})"
        )
    return name


def default_params(spec, learn, dtype=torch.float32, device=None) -> dict:
    """The spec's current values of the learned leaves as a flat dict of
    0-d tensors: the fit's initial point."""
    params = {}
    for name in learn:
        name = resolve_param(name)
        if name == "density":
            if spec.plasma.density <= 0:
                raise ValueError("learning 'density' needs spec.plasma.density > 0 (the trainable scale "
                                 "multiplies the spec-built weights)")
            value = spec.plasma.density
        else:
            if spec.laser is None:
                raise ValueError(f"learning {name!r} needs a spec with a laser (spec.laser is None)")
            value = getattr(spec.laser, name.split(".", 1)[1])
        params[name] = torch.tensor(value, dtype=dtype, device=device)
    return params


def _cast_floats(tree, dtype):
    """Every float tensor of a dataclass cast to ``dtype``; ints and bools
    keep their types."""
    return dataclasses.replace(tree, **{
        f.name: getattr(tree, f.name).to(dtype) if getattr(tree, f.name).is_floating_point()
        else getattr(tree, f.name)
        for f in dataclasses.fields(tree)})


class StateBuilder:
    """The eager, parameter-independent set-up and the differentiable
    `build(params)`.

    Construction builds the spec's particles (cast to ``dtype``), zero
    fields, the global sort and the bins, on ``device`` (default ``cuda``);
    a binning overflow grows the capacity once, as `Simulation` does, and
    the grown configuration is ``self.config``. `build(params)` injects the
    laser with the parameters as tensor overrides and scales the weights by
    the density parameter: it touches no index."""

    def __init__(self, spec, config, *, dtype=None, device=None):
        from repro_torch.api.facade import build_particles, resolve_device
        from repro_torch.core.binning import choose_capacity
        from repro_torch.pic.grid import FieldState
        from repro_torch.pic.simulation import init_state

        if spec.mesh.shape is not None:
            raise ValueError("the gradient subsystem differentiates the single-device windowed driver; "
                             f"spec {spec.name!r} names mesh {spec.mesh.shape}")
        self.spec = spec
        self.device = resolve_device(device)
        self.dtype = torch.float32 if dtype is None else dtype
        particles = _cast_floats(build_particles(spec, device=self.device), self.dtype)
        fields0 = FieldState.zeros(spec.grid.shape, self.dtype, device=self.device)
        state0, overflow = init_state(fields0, particles, config)
        if overflow:
            config = dataclasses.replace(config, capacity=choose_capacity(config.capacity * 2 // 3 * 2))
            state0, overflow = init_state(fields0, particles, config)
            if overflow:
                raise ValueError("initial binning overflow persists after capacity growth; "
                                 "set spec.sort.capacity explicitly")
        self.config = config
        self._state0 = state0

    def initial_params(self, learn) -> dict:
        return default_params(self.spec, learn, self.dtype, self.device)

    def build(self, params: dict):
        """The initial `PICState` at ``params`` (a flat dict keyed by
        canonical LEARNABLE names; a missing key takes the spec's value)."""
        from repro_torch.pic.laser import inject_laser

        p = {k: v.to(dtype=self.dtype, device=self.device) if isinstance(v, torch.Tensor)
             else torch.tensor(v, dtype=self.dtype, device=self.device) for k, v in params.items()}
        state = self._state0
        particles = state.particles
        if "density" in p:
            scale = p["density"] / torch.tensor(self.spec.plasma.density, dtype=self.dtype, device=self.device)
            particles = dataclasses.replace(particles, w=particles.w * scale)
        fields = state.fields  # zeros at the builder's dtype
        if self.spec.laser is not None:
            fields = inject_laser(fields, self.spec.grid, self.spec.laser, a0=p.get("laser.a0"),
                                  waist=p.get("laser.waist"), duration=p.get("laser.duration"))
        return dataclasses.replace(state, fields=fields, particles=particles)
