"""The distributed pieces, every mesh axis held on one device (a
``ppermute`` is a roll along a stacked shard axis, a ``psum`` a sum over
it), or an axis spread over processes, one a rank, each holding a block of
the stack (`ranks`). Counterpart of `repro.distributed`: fault tolerance (the chaos
harness and the windowed-run supervisor of the PIC drivers, and the
training loop's `FailureInjector`, `StragglerMonitor` and `Supervisor`,
`fault`), the communication options (`comm.CommSpec`), quantized payloads
(`compression`: the PIC driver's migration rows and the int8
error-feedback gradient all-reduce), the language-model stack's
logical-axis rules and the PIC driver's load-aware mesh split
(`sharding`), and GPipe over stacked stages (`pipeline`)."""

from repro_torch.distributed.fault import FailureInjector, StragglerMonitor, Supervisor  # noqa: F401
from repro_torch.distributed.sharding import (  # noqa: F401
    Rules,
    constrain,
    decode_rules,
    train_rules,
    tree_specs,
    use_rules,
)
