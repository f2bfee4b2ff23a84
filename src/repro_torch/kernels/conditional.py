"""Device-side conditionals for a captured step: IF nodes in a CUDA graph.

The reference decides its re-sort with `lax.cond` inside a compiled scan.
Here a step is captured once as a `torch.cuda.CUDAGraph` and a decision
becomes a CUDA 12.4 IF node (`csrc/graph_conditional.cu`): at every replay
the graph reads the predicate on the device and runs the branch only when
it holds, so the host never reads it.

The step function takes a decider and calls its ``run_if(pred, body)``:

  - `HostDecider`: tests a CPU predicate where it lies (no device is
    involved) and reads a CUDA one on the host through a reader the caller
    passes (one device-to-host read each);
  - `GraphCapture`: inside its `capturing` block, captures ``body`` into an
    IF node on ``pred``;
  - `EveryBranch`: runs every body and reads nothing (the warm-up before a
    capture).

So the CPU tests run the very function that is captured on the card. A
body must not leak tensors to the code after it: what it computes it writes
in place into tensors that outlive the graph.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

from repro_torch.kernels.build import check, load_library

#: IF nodes nested deeper than this are refused (the window step nests two)
MAX_DEPTH = 2


class HostDecider:
    """Decides on the host. ``read`` moves a CUDA tensor to the host
    (default ``Tensor.cpu``); a caller passes its counting reader."""

    def __init__(self, read: Callable | None = None):
        self.read = read or torch.Tensor.cpu

    def run_if(self, pred: torch.Tensor, body: Callable[[], None]) -> None:
        if bool(pred if pred.device.type == "cpu" else self.read(pred)):
            body()


class EveryBranch:
    """Runs every body, whatever its predicate, and reads nothing."""

    def run_if(self, pred: torch.Tensor, body: Callable[[], None]) -> None:
        body()


class GraphCapture:
    """Captures work into ``graph``; within `capturing`, `run_if` makes an
    IF node. IF nodes nest up to `MAX_DEPTH` deep."""

    def __init__(self, graph: torch.cuda.CUDAGraph, device: torch.device):
        load_library()  # never build inside a capture
        self.graph, self.device = graph, device
        # the capture's stream and the bodies' come from PyTorch's stream
        # pool, which hands out its 32 streams in turn: taken together they
        # are distinct, so no body is ever captured on a capturing stream
        self.stream = torch.cuda.Stream(device)
        self.streams = [torch.cuda.Stream(device) for _ in range(MAX_DEPTH)]
        self.depth = 0

    @contextlib.contextmanager
    def capturing(self):
        """Capture the work issued inside the block. Allocations, the IF
        bodies' included, come from the graph's private memory pool. The
        capture is this thread's alone (``thread_local``): another thread's
        CUDA calls, such as a service's event loop, cannot invalidate it."""
        index, pool = self.device.index, torch.cuda.graph_pool_handle()
        with torch.cuda.graph(self.graph, pool=pool, stream=self.stream, capture_error_mode="thread_local"):
            # The IF bodies are captured on streams of their own, whose
            # captures the graph's allocation filter (its capture id) does
            # not match, and the allocator takes one filter per pool: swap
            # the graph's filter for one that routes every allocation of
            # this thread to the pool. The capture's end removes this one.
            torch._C._cuda_endAllocateToPool(index, pool)
            torch._C._cuda_beginAllocateCurrentThreadToPool(index, pool)
            yield
        torch._C._cuda_releasePool(index, pool)  # the reference the swap took

    def run_if(self, pred: torch.Tensor, body: Callable[[], None]) -> None:
        if self.depth >= len(self.streams):
            raise RuntimeError(f"IF nodes nested deeper than {len(self.streams)}")
        pred = pred.to(torch.bool).contiguous()
        lib = load_library()
        stream = torch.cuda.current_stream(self.device)
        body_stream = self.streams[self.depth]
        check(lib.mpic_graph_if_begin(stream.cuda_stream, pred.data_ptr(), body_stream.cuda_stream),
              "graph IF begin")
        self.depth += 1
        try:
            with torch.cuda.stream(body_stream):
                body()
        finally:
            self.depth -= 1
            check(lib.mpic_graph_if_end(body_stream.cuda_stream), "graph IF end")
