"""Public API of the port: the trimmed declarative spec, the scenario
registry (uniform, lwfa) and the single-device driver facade.

    from repro_torch.api import scenario, make_simulation
    sim = make_simulation(scenario("uniform", grid=(64, 64, 64), order=3))
    sim.run()
    print(sim.diagnostics())
"""

from repro_torch.api.facade import (  # noqa: F401
    build_fields,
    build_particles,
    make_simulation,
    pic_config,
    resolve_device,
)
from repro_torch.api.registry import apply_overrides, register_scenario, scenario, scenario_names  # noqa: F401
from repro_torch.api.spec import (  # noqa: F401
    DepositionSpec,
    DriftSpec,
    PerturbSpec,
    PlasmaSpec,
    ProfileSpec,
    RunSpec,
    SimSpec,
    SortSpec,
)
from repro_torch.core.resort_policy import SortPolicyConfig  # noqa: F401
from repro_torch.pic.grid import GridSpec  # noqa: F401
from repro_torch.pic.laser import LaserSpec  # noqa: F401
