"""Async simulation service (counterpart of `repro.launch.sim_serve`).

Jobs are serialized `SimSpec` JSON. The queue groups jobs of one
`spec_signature` into one `EnsembleSimulation` batch, runs its windows in a
worker thread and streams each job's window bundle back as it lands. The
captured windows of each signature are cached (`ExecutableCache`, an LRU):
one window a batch size, each a captured step over the batch's member
axis, so a repeat batch of a signature and size copies its members into
the captured buffers and replays, capturing nothing; evicting a signature
frees its graphs and buffers.

Protocol (asyncio and JSON lines):

    svc = SimService(max_batch=8, max_queue=64)
    await svc.start()
    job_id = await svc.submit(spec.to_json())
    async for event in svc.results(job_id):
        ...   # {"event": "window", ...} per window, then one of
        ...   # done | error | rejected (admission bound) | cancelled
    svc.cancel(job_id)   # queued: dropped; running: stream cut short
    await svc.close()

`serve(svc, host, port)` offers the same protocol over a JSON-lines TCP
socket (one request object in, its event stream out).

All CUDA work of the service (building the members, capture, replay, the
bundle read) runs in its one worker thread, which sets the device for
itself; events carry Python numbers only. The service runs on ``cuda``
unless it is given another device.

    python -m repro_torch.launch.sim_serve --smoke      # self-checking smoke run
    python -m repro_torch.launch.sim_serve --smoke --device cpu  # the same without a card
    python -m repro_torch.launch.sim_serve --port 8571  # serve
"""

from __future__ import annotations

import argparse
import asyncio
import itertools
import json
import sys
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import torch

from repro_torch.api.facade import build_fields, build_particles, pic_config, resolve_device, spec_signature
from repro_torch.api.spec import SimSpec
from repro_torch.pic.ensemble import EnsembleSimulation, make_ensemble_window_fn, member_bundle
from repro_torch.pic.simulation import WindowFn

__all__ = ["ExecutableCache", "SimJob", "SimService", "serve"]


class ExecutableCache:
    """Signature-keyed LRU of ensemble-window callables. Each entry is a
    fresh `make_ensemble_window_fn` callable, whose store holds that
    signature's captured windows (one per batch size, each the bucket's
    batched step over that many members), and nothing else, no job and no
    ensemble: evicting the least recently used signature frees that
    bucket's graphs and buffers, so the service holds at most ``maxsize``
    signatures' windows."""

    def __init__(self, maxsize: int = 8):
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self.maxsize = maxsize
        self._entries: OrderedDict[str, WindowFn] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, signature: str) -> WindowFn:
        fn = self._entries.get(signature)
        if fn is not None:
            self.hits += 1
            self._entries.move_to_end(signature)
            return fn
        self.misses += 1
        fn = self._entries[signature] = make_ensemble_window_fn()
        while len(self._entries) > self.maxsize:
            self._entries.popitem(last=False)
            self.evictions += 1
        return fn

    def stats(self) -> dict:
        return {"size": len(self._entries), "maxsize": self.maxsize, "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions}


@dataclass
class SimJob:
    """One submitted simulation: its spec, its signature and the event queue
    its client drains through `SimService.results`."""

    id: str
    spec: SimSpec
    signature: str
    status: str = "queued"
    events: asyncio.Queue = field(default_factory=asyncio.Queue)


class SimService:
    """Async job queue that runs jobs of one signature as one ensemble.

    The worker takes the oldest queued job, waits up to ``batch_wait``
    seconds for more of its signature (up to ``max_batch``), puts the others
    back in order, and runs the batch as one `EnsembleSimulation` on
    ``device`` (default ``cuda``) through the signature's cached window callable.
    Each window bundle goes to each job's queue as a ``window`` event; a
    terminal ``done`` (final diagnostics and the history) or ``error`` ends
    the stream. ``graph_captures`` and ``window_builds`` sum the batches'
    (a cache hit makes neither)."""

    def __init__(self, *, max_batch: int = 8, batch_wait: float = 0.05, cache_size: int = 8, max_queue: int = 0,
                 device=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {max_queue}")
        self.max_batch = max_batch
        self.batch_wait = batch_wait
        self.max_queue = max_queue  # admission bound; 0 = unbounded
        self.device = resolve_device(device)
        self.cache = ExecutableCache(cache_size)
        self.jobs: dict[str, SimJob] = {}
        self._pending: asyncio.Queue = asyncio.Queue()
        self._ids = itertools.count()
        self._worker: asyncio.Task | None = None
        self._executor: ThreadPoolExecutor | None = None
        self.batches_run = 0
        self.jobs_done = 0
        self.queued = 0      # jobs admitted, not yet running
        self.rejected = 0    # jobs refused at the admission bound
        self.cancelled = 0   # cancel() calls that hit a live job
        self.graph_captures = 0
        self.window_builds = 0

    # -- client side ------------------------------------------------------------

    async def start(self) -> None:
        if self._worker is None:
            self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="sim-serve")
            self._worker = asyncio.get_running_loop().create_task(self._run_loop())

    async def submit(self, spec_json: str | dict) -> str:
        """Accept a serialized SimSpec (JSON text or dict) and return the job
        id to stream `results` from. A malformed spec raises here: bad input
        is the client's error, not the worker's."""
        spec = SimSpec.from_dict(spec_json) if isinstance(spec_json, dict) else SimSpec.from_json(spec_json)
        job = SimJob(id=f"job-{next(self._ids)}", spec=spec, signature=spec_signature(spec))
        self.jobs[job.id] = job
        if self.max_queue and self.queued >= self.max_queue:
            # refuse loudly rather than buffer without bound: the client sees
            # a terminal event, not a hang
            job.status = "rejected"
            self.rejected += 1
            job.events.put_nowait({
                "event": "rejected", "job": job.id, "queued": self.queued, "max_queue": self.max_queue,
                "message": f"queue full ({self.queued}/{self.max_queue}); retry after draining a result stream",
            })
            return job.id
        self.queued += 1
        await self._pending.put(job)
        return job.id

    def cancel(self, job_id: str) -> str:
        """Cancel a job: a queued one is dropped at once (a terminal
        ``cancelled`` event); a running one is flagged, its stream stops at
        the next window and ends with ``cancelled`` instead of ``done``.
        Returns the job's status; a finished job is left as it is. Raises
        KeyError for an unknown id."""
        job = self.jobs[job_id]
        if job.status == "queued":
            job.status = "cancelled"
            self.queued -= 1
            self.cancelled += 1
            job.events.put_nowait({"event": "cancelled", "job": job.id, "was": "queued"})
        elif job.status == "running":
            job.status = "cancelling"
            self.cancelled += 1
        return job.status

    async def results(self, job_id: str):
        """The job's events, up to and including its terminal one."""
        job = self.jobs[job_id]
        while True:
            event = await job.events.get()
            yield event
            if event["event"] in ("done", "error", "rejected", "cancelled"):
                return

    async def close(self) -> None:
        if self._worker is not None:
            await self._pending.put(None)
            await self._worker
            self._worker = None
            self._executor.shutdown(wait=True)
            self._executor = None

    # -- worker side ------------------------------------------------------------

    async def _run_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            head = await self._pending.get()
            if head is None:
                return
            if head.status != "queued":  # cancelled while waiting
                continue
            batch = await self._gather_batch(head)
            self.batches_run += 1
            for job in batch:
                job.status = "running"
                self.queued -= 1
            try:
                await loop.run_in_executor(self._executor, self._run_batch, batch, loop)
            except Exception as err:  # a failed batch ends its jobs' streams, not the worker
                for job in batch:
                    job.status = "error"
                    job.events.put_nowait({"event": "error", "job": job.id, "message": str(err)})
            else:
                for job in batch:
                    if job.status == "cancelling":
                        job.status = "cancelled"
                    else:
                        job.status = "done"
                        self.jobs_done += 1

    async def _gather_batch(self, head: SimJob) -> list[SimJob]:
        """Queued jobs of ``head``'s signature (waiting briefly for more);
        the others go back in order of arrival."""
        loop = asyncio.get_running_loop()
        batch, requeue = [head], []
        deadline = loop.time() + self.batch_wait
        while len(batch) < self.max_batch:
            timeout = deadline - loop.time()
            if timeout <= 0 and self._pending.empty():
                break
            try:
                nxt = await asyncio.wait_for(self._pending.get(), max(timeout, 0.0))
            except asyncio.TimeoutError:
                break
            if nxt is None:
                self._pending.put_nowait(None)  # keep the shutdown signal
                break
            if nxt.status != "queued":  # cancelled while waiting
                continue
            if nxt.signature == head.signature:
                batch.append(nxt)
            else:
                requeue.append(nxt)
        for job in requeue:
            self._pending.put_nowait(job)
        return batch

    def _run_batch(self, batch: list[SimJob], loop) -> None:
        """The worker thread's part: build the ensemble over the signature's
        cached windows, run it, stream each window bundle back."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)  # per thread
        specs = [job.spec for job in batch]
        ens = EnsembleSimulation(
            [(build_fields(s, device=self.device), build_particles(s, device=self.device)) for s in specs],
            pic_config(specs[0]), specs[0].sort.policy, specs=specs, window_fn=self.cache.get(batch[0].signature))
        seen = [0] * len(batch)

        def post(job: SimJob, event: dict) -> None:
            loop.call_soon_threadsafe(job.events.put_nowait, event)

        def on_window(e: EnsembleSimulation, host: dict) -> None:
            for slot, job in enumerate(batch):
                if job.status == "cancelling":  # flagged: stop streaming
                    continue
                mb = member_bundle(host, slot)
                records = e.histories[slot][seen[slot]:]
                seen[slot] = len(e.histories[slot])
                post(job, {"event": "window", "job": job.id, "step": int(e.host_step[slot]),
                           "n_done": int(mb["n_done"]), "n_sorts": int(mb["n_sorts"]),
                           "halt_code": int(mb["halt_code"]), "records": records})

        try:
            ens.run(on_window=on_window)
        finally:
            self.graph_captures += ens.graph_captures
            self.window_builds += ens.window_builds
        for slot, job in enumerate(batch):
            if job.status == "cancelling":
                post(job, {"event": "cancelled", "job": job.id, "was": "running", "step": int(ens.host_step[slot])})
                continue
            post(job, {"event": "done", "job": job.id, "signature": job.signature, "batch_size": len(batch),
                       "diagnostics": ens.diagnostics(slot), "history": ens.histories[slot]})


async def serve(service: SimService, host: str = "127.0.0.1", port: int = 8571):
    """JSON-lines TCP front end: a line ``{"spec": {...}}`` gets the job's
    event stream, ending with its terminal event; ``{"cancel": "job-N"}``
    gets one acknowledgement line."""
    await service.start()

    async def handle(reader, writer):
        try:
            while line := await reader.readline():
                try:
                    request = json.loads(line)
                    if "cancel" in request:
                        status = service.cancel(request["cancel"])
                        writer.write((json.dumps({"event": "cancel", "job": request["cancel"],
                                                  "status": status}) + "\n").encode())
                        await writer.drain()
                        continue
                    job_id = await service.submit(request["spec"])
                except Exception as err:  # a bad request answers that client, the server goes on
                    writer.write((json.dumps({"event": "error", "message": str(err)}) + "\n").encode())
                    await writer.drain()
                    continue
                async for event in service.results(job_id):
                    writer.write((json.dumps(event) + "\n").encode())
                    await writer.drain()
        finally:
            writer.close()

    return await asyncio.start_server(handle, host, port)


# -- smoke run ------------------------------------------------------------------


async def _smoke(args) -> int:
    from repro_torch.api.registry import scenario

    base = scenario("uniform", grid=(args.grid,) * 3, ppc=2, steps=args.steps, window=args.window,
                    diagnostics_every=args.window)
    svc = SimService(max_batch=args.members, batch_wait=0.25, device=args.device)
    print(f"sim_serve smoke on {svc.device}")
    await svc.start()
    t0 = time.perf_counter()
    finals, windows = {}, {}
    ids = []
    for rnd in range(2):  # the second round: the same signature and size, a cache hit
        ids = [await svc.submit(base.to_json()) for _ in range(args.members)]
        for job_id in ids:
            windows[job_id] = 0
            async for event in svc.results(job_id):
                if event["event"] == "window":
                    windows[job_id] += 1
                elif event["event"] == "error":
                    print(f"FAIL: {job_id} errored: {event['message']}")
                    return 1
                else:
                    finals[job_id] = event
        if rnd == 0:
            builds = svc.window_builds
    elapsed = time.perf_counter() - t0
    await svc.close()

    ok = True
    for job_id in finals:
        steps = finals[job_id]["diagnostics"]["step"]
        if steps != args.steps or windows[job_id] < 1:
            print(f"FAIL: {job_id} ran {steps} steps (wanted {args.steps}) in {windows[job_id]} window events")
            ok = False
    sizes = {f["batch_size"] for f in finals.values()}
    if sizes != {args.members}:
        print(f"FAIL: jobs ran in batches of {sorted(sizes)}, wanted batches of {args.members}")
        ok = False
    if svc.window_builds != builds or svc.cache.stats()["hits"] != 1:
        print(f"FAIL: the repeat batch built {svc.window_builds - builds} windows, cache {svc.cache.stats()}")
        ok = False
    # admission control and cancellation, deterministically: a bounded
    # service whose worker never starts, so its queue cannot race
    adm = SimService(max_batch=1, max_queue=1, device=args.device)
    j1 = await adm.submit(base.to_json())
    j2 = await adm.submit(base.to_json())  # over the bound: rejected
    ev2 = [e async for e in adm.results(j2)]
    if [e["event"] for e in ev2] != ["rejected"]:
        print(f"FAIL: an over-bound submit streamed {ev2}, wanted one rejected")
        ok = False
    status = adm.cancel(j1)
    ev1 = [e async for e in adm.results(j1)]
    if status != "cancelled" or [e["event"] for e in ev1] != ["cancelled"]:
        print(f"FAIL: a queued cancel gave status={status}, events={ev1}")
        ok = False
    if (adm.queued, adm.rejected, adm.cancelled) != (0, 1, 1):
        print(f"FAIL: admission counters queued={adm.queued} rejected={adm.rejected} cancelled={adm.cancelled}")
        ok = False
    print(f"sim_serve smoke: {len(finals)} jobs in 2 batches of {args.members}, {windows[ids[0]]} windows/job, "
          f"cache {svc.cache.stats()}, windows built {svc.window_builds} (the repeat batch none), captures "
          f"{svc.graph_captures}, admission rejected={adm.rejected} cancelled={adm.cancelled}, {elapsed:.2f} s -> "
          f"{'OK' if ok else 'FAIL'}")
    return 0 if ok else 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--smoke", action="store_true",
                        help="run the self-checking smoke run (two batches of --members jobs) and exit")
    parser.add_argument("--members", type=int, default=2, help="smoke: jobs a batch")
    parser.add_argument("--grid", type=int, default=6, help="smoke: cells per grid axis")
    parser.add_argument("--steps", type=int, default=8, help="smoke: steps per job")
    parser.add_argument("--window", type=int, default=4, help="smoke: window length")
    parser.add_argument("--device", default=None, help="torch device (default: cuda; `cpu` runs without a card)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8571)
    args = parser.parse_args(argv)

    if args.smoke:
        return asyncio.run(_smoke(args))

    async def _serve_forever():
        svc = SimService(device=args.device)
        server = await serve(svc, args.host, args.port)
        addr = server.sockets[0].getsockname()
        print(f"sim_serve: listening on {addr[0]}:{addr[1]} (JSON lines), device {svc.device}")
        async with server:
            await server.serve_forever()

    asyncio.run(_serve_forever())
    return 0


if __name__ == "__main__":
    sys.exit(main())
