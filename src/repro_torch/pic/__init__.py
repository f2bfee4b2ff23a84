"""PIC substrate on PyTorch: Yee fields, Boris pusher, plasma init, the
single-device simulation loop (windowed and host-driven), the batched
ensemble engine and the distributed driver (a 2-D shard mesh on one
device, or spread over the ranks of a process group). Counterpart of
`repro.pic`."""

from repro_torch.pic.grid import B_STAGGER, E_STAGGER, FieldState, GridSpec  # noqa: F401
from repro_torch.pic.laser import LaserSpec, inject_laser  # noqa: F401
from repro_torch.pic.maxwell import maxwell_step, push_b, push_e  # noqa: F401
from repro_torch.pic.plasma import (  # noqa: F401
    ParticleState,
    apply_counter_drift,
    counter_streaming_plasma,
    perturb_velocity,
    profiled_plasma,
    uniform_plasma,
)
from repro_torch.pic.pusher import advance_positions, boris_push, lorentz_gamma, wrap_periodic  # noqa: F401
from repro_torch.pic.simulation import (  # noqa: F401
    HALT_NAMES,
    PICConfig,
    PICState,
    Simulation,
    clear_windows,
    ensemble_run_window,
    global_sort,
    global_sort_device,
    init_state,
    padded_fields,
    pic_run_window,
    pic_step,
    pic_step_donated,
    state_from_reference,
)
from repro_torch.pic.ensemble import (  # noqa: F401,E402
    EnsembleSimulation,
    make_ensemble_window_fn,
    member_bundle,
    stack_trees,
    unstack_tree,
)
from repro_torch.pic.distributed import DistConfig, DistState, PicMesh, make_pic_mesh  # noqa: F401,E402
from repro_torch.pic.dist_simulation import DistSimulation  # noqa: F401,E402
