"""The ten language-model architectures as one stacked-period model family.
Counterpart of `repro.models`."""

from repro_torch.models.common import LayerSpec, ModelConfig, MoEConfig  # noqa: F401
from repro_torch.models.convert import params_from_numpy, params_to_numpy  # noqa: F401
from repro_torch.models.loss import cross_entropy  # noqa: F401
from repro_torch.models.transformer import (  # noqa: F401
    decode_state_axes,
    decode_step,
    encode,
    forward,
    init_decode_state,
    init_params,
    param_axes,
)
