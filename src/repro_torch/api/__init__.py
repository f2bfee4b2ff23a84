"""Public API of the port: the declarative spec (JSON shared with
`repro.api`), the scenario registry (uniform, lwfa, two_stream, weibel),
the single-device driver facade, its checkpoints and its fault tolerance
(the health sentinel's `HealthConfig`, the chaos harness's `FaultSpec`,
`SimCheckpointer` autosave, `SimulationHealthError`).

    from repro_torch.api import scenario, make_simulation, load_simulation
    sim = make_simulation(scenario("uniform", grid=(64, 64, 64), order=3))
    sim.run()
    print(sim.diagnostics())
    sim.save("ckpt")              # loads in repro_torch and in repro
    sim = load_simulation("ckpt")
"""

from repro_torch.api.facade import (  # noqa: F401
    SimCheckpointer,
    clean_stale_tmp,
    build_fields,
    build_particles,
    load_simulation,
    make_simulation,
    pic_config,
    resolve_device,
    restore_simulation,
    save_simulation,
)
from repro_torch.api.registry import (  # noqa: F401
    apply_overrides,
    register_scenario,
    scenario,
    scenario_names,
    two_stream_growth_rate,
    weibel_growth_rate,
)
from repro_torch.api.spec import (  # noqa: F401
    CommSpec,
    DepositionSpec,
    DriftSpec,
    FaultSpec,
    HealthConfig,
    MeshSpec,
    PerturbSpec,
    PlasmaSpec,
    ProfileSpec,
    RunSpec,
    SimSpec,
    SortSpec,
)
from repro_torch.core.health import SimulationHealthError  # noqa: F401
from repro_torch.core.resort_policy import SortPolicyConfig  # noqa: F401
from repro_torch.pic.grid import GridSpec  # noqa: F401
from repro_torch.pic.laser import LaserSpec  # noqa: F401
