"""The distributed pieces: fault tolerance (the chaos harness and the
windowed-run supervisor of the drivers, and the training loop's
`FailureInjector`, `StragglerMonitor` and `Supervisor`,
`repro_torch.distributed.fault`), the communication options
(`comm.CommSpec`), compressed migration payloads (`compression`) and the
load-aware mesh split (`sharding`). Counterpart of `repro.distributed`
except its LM sharding rules, pipeline and gradient compression."""
