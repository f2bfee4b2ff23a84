"""Fault tolerance of the drivers: the declarative chaos harness and the
windowed-run supervisor (`repro_torch.distributed.fault`). Counterpart of
the PIC half of `repro.distributed`."""
