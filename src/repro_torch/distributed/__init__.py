"""The drivers' distributed pieces: fault tolerance (the chaos harness and
the windowed-run supervisor, `repro_torch.distributed.fault`), the
communication options (`comm.CommSpec`), compressed migration payloads
(`compression`) and the load-aware mesh split (`sharding`). Counterpart of
the PIC half of `repro.distributed`."""
