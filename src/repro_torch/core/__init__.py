"""Matrix-PIC core on PyTorch: counterpart of `repro.core` for the
single-device simulation and the generalized matrix scatter."""

from repro_torch.core.binning import (  # noqa: F401
    INVALID,
    BinnedLayout,
    BinSlab,
    bin_slab_staging,
    bin_slab_values,
    build_bin_slab,
    build_bins,
    cell_coords,
    cell_index,
    choose_capacity,
    permute_tree,
    slot_gather,
    sort_permutation,
)
from repro_torch.core.deposition import (  # noqa: F401
    CURRENT_STAGGER,
    NO_STAGGER,
    STAGGER_X,
    STAGGER_Y,
    STAGGER_Z,
    binned_shape_factors,
    deposit_current,
    deposit_current_matrix_fused,
    deposit_matrix,
    deposit_rhocell,
    deposit_scatter,
    fused_bin_slab,
    fused_deposit_grids,
)
from repro_torch.core.gather import (  # noqa: F401
    EB_STAGGERS,
    extract_neighborhoods,
    fused_gather_bins,
    gather_fields_fused,
    gather_matrix,
    gather_scatter,
    pack_neighborhoods,
)
from repro_torch.core.gpma import GPMAStats, gpma_update  # noqa: F401
from repro_torch.core.health import (  # noqa: F401
    HALT_BIN_OVERFLOW,
    HALT_IMBALANCE,
    HALT_INVARIANT,
    HALT_MIG_RECV,
    HALT_MIG_SEND,
    HALT_NAMES,
    HALT_NONE,
    HALT_NONFINITE,
    INVARIANT_NAMES,
    HealthConfig,
    SimulationHealthError,
    classify_health,
    nonfinite_count,
)
from repro_torch.core.matrix_scatter import bin_items, matrix_scatter_add, scatter_add_ref  # noqa: F401
from repro_torch.core.resort_policy import (  # noqa: F401
    REASON_NAMES,
    HostPolicyState,
    ResortPolicy,
    SortPolicyConfig,
    SortPolicyState,
    perf_proxy,
    policy_init,
    policy_reset,
    policy_update,
)
from repro_torch.core.rhocell import (  # noqa: F401
    fold_guards,
    reduce_rhocell,
    reduce_rhocell_separable,
    reduce_rhocell_tail,
    unfold_guards,
)
from repro_torch.core.shape_functions import (  # noqa: F401
    CANONICAL_FLOPS_PER_PARTICLE,
    bspline,
    max_guard,
    packed_axis_weights,
    shape_weights,
    shape_weights_window,
    support,
    unified_support,
)
