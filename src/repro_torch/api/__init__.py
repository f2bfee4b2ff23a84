"""Public API of the port: the declarative spec (JSON shared with
`repro.api`), the scenario registry (uniform, lwfa, two_stream, weibel),
the driver facade (single-device, or a shard mesh on one device), its
checkpoints and its fault tolerance
(the health sentinel's `HealthConfig`, the chaos harness's `FaultSpec`,
`SimCheckpointer` autosave, `SimulationHealthError`), and ensembles
(`EnsembleSpec`, `make_ensemble`, `spec_signature`, member checkpoints)
and gradients (`GradSpec`, `make_objective`, `fit_simulation`).

    from repro_torch.api import scenario, make_simulation, load_simulation
    sim = make_simulation(scenario("uniform", grid=(64, 64, 64), order=3))
    sim.run()
    print(sim.diagnostics())
    sim.save("ckpt")              # loads in repro_torch and in repro
    sim = load_simulation("ckpt")

    fit = fit_simulation(scenario("lwfa"), GradSpec(learn=("laser.a0",)), iters=8)

    ens = make_ensemble(EnsembleSpec.sweep(scenario("two_stream"), {"drift": [0.1, 0.2]}, replicas=4))
    ens.run()                     # one bucket of 8 members, one host read a window
    ens.save_member(3, "m3")      # a standard single-driver checkpoint
"""

from repro_torch.api.facade import (  # noqa: F401
    EnsembleRun,
    SimCheckpointer,
    bucket_specs,
    clean_stale_tmp,
    build_fields,
    dist_config,
    build_particles,
    fit_simulation,
    load_simulation,
    make_ensemble,
    make_objective,
    make_simulation,
    pic_config,
    resolve_device,
    restore_ensemble_member,
    restore_simulation,
    save_ensemble_member,
    save_simulation,
    spec_signature,
)
from repro_torch.api.registry import (  # noqa: F401
    apply_overrides,
    register_scenario,
    scenario,
    scenario_names,
    two_stream_growth_rate,
    two_stream_linear_energy,
    weibel_growth_rate,
)
from repro_torch.api.spec import (  # noqa: F401
    CommSpec,
    DepositionSpec,
    DriftSpec,
    EnsembleSpec,
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
from repro_torch.grad.spec import GradSpec  # noqa: F401
from repro_torch.core.resort_policy import SortPolicyConfig  # noqa: F401
from repro_torch.pic.grid import GridSpec  # noqa: F401
from repro_torch.pic.laser import LaserSpec  # noqa: F401
