#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi) — no CUDA, no run;
2. build: the CUDA kernels of src/repro_torch/csrc, from source;
3. all six kernels against their plain PyTorch versions: (a) at orders
   1-3 on a small grid; the three fused kernels at capacity 48 with an
   all-gap and a full cell, on one-cell columns and on a 1000-cell column,
   the packed deposition bit for bit against its plain version, the reduced
   one bit for bit against the packed kernel + z pass, and both and the
   fused gather against their own repeated launches; the unfused kernels at
   the M and N of every stagger on an awkward cell count, at odd
   capacities and on operands off a 16-byte boundary (their element-copy
   route), and at an (M, N) outside the templated ones, in float32 and,
   for `bin_outer_product` and `segment_accumulate`, bfloat16;
   `bin_outer_product` also with all-zero cells, its two copy routes and
   two launches bit-equal; (b) at
   the main path's shapes (order 3,
   128^3 cells, capacity 32; `segment_accumulate` at the MoE combine of
   mixtral_8x22b and the embedding gradient of phi3_mini_3p8b), with each
   one's time, its plain version's, a one-call PyTorch yardstick's and the
   least time the card could take (its bound);
4. the main path at full size: `make_simulation(scenario("uniform",
   grid=(128,)*3, ppc=2, order=3, steps=32, window=16)).run()` — 16.8 M
   macro-particles, third-order (QSP) shapes — with launch counts, step
   time, peak memory, host reads per window (one: each window replays the
   step's CUDA graph), energies and charge conservation; then the same path
   with backend "cuda" (the packed deposition kernel);
5. the unfused path (`deposition="matrix_unfused"`, `gather=
   "matrix_unfused"`: 3 + 6 kernel launches a step) and the paper's scatter
   baseline at the same size;
6. the other backends and modes at 32^3 ("cuda" and "torch"; matrix_unfused,
   scatter, rhocell) against the default "cuda_reduced" run;
7. lwfa at its registry size: laser, density step, dead particles, cap 48;
8. `matrix_scatter_add` at the two language-model shapes of phase 3b, on
   its default backend (``auto``, which must resolve to the kernel untimed);
9. the sort-mode ablation at the main shapes (window 8): ``rebuild`` and
   ``global`` on the default path, 8 steps after a warm-up window, and
   ``none`` with the scatter deposition and gather (the scatter baseline
   with no bin upkeep), 4 steps after a warm-up window; each against
   phase 4's ``incremental`` step time;
10. the host-driven loop (``window=None``): 8 steps of the main path, then
   at 32^3 20 host-loop steps bit-equal to 20 windowed steps (the
   performance trigger off);
11. checkpoints at 32^3: saved at step 10, loaded into a fresh driver and
   run 10 more steps, bit-equal to an uninterrupted 20-step run, in the
   ``incremental`` and ``global`` sort modes;
12. the two_stream and weibel growth rates at their registry sizes (300 and
   260 steps) within 0.75-1.25 of the analytic rates;
13. examples/torch_pm_nbody.py at its default size (4096 bodies, 16^3, 40
   steps): kernels #4 and #5 launched, finite energies, mass conserved;
14. fault tolerance on the card, at the main shapes: the health sentinel on
   and no fault, bit-equal to the sentinel off (step time, peak memory,
   one host read a window); a NaN in ``ez`` and doubled weights injected at
   step 20, each one halt, one retry and a final state bit-equal to the
   clean run's, one host read per window entered; the snapshot's bytes and
   its copy time; at 32^3 a persistent NaN from ``cuda_reduced`` that walks
   the ladder down to ``torch`` and ends in `SimulationHealthError`, and a
   crash at step 8 restored from its autosave, bit-equal;
15. the dispatcher's autotune: each ``deposit_fused`` key the run timed
   (phases 4-14, and orders 1 and 2 at the main grid), its two kernel
   candidates' medians at the driver's mean occupancy and the winner,
   and where the timing overruled the priority order; at the main shapes a
   second driver of the same key resolved from the memo and, after the
   memo is cleared, from the cache file, with no second timing, and
   ``gather_fused`` untimed (one kernel); the seconds the timing adds to
   set-up; the main path's step time under the resolved backend against
   phase 4's;
16. ensembles on the card: (a) `make_ensemble(EnsembleSpec.replicate(main,
   2))` at the main shapes, one bucket advanced through one captured graph
   a window step: each member bit-equal (fields, particles, slots, slab,
   policy state, sorts, rebuilds) to its own solo windowed run (member 0's
   is phase 4's run), 1.00 host read a window, one capture, each resolved
   kernel launched once a member-step; ms per member-step against phase
   4's ms/step and peak memory; (b) the sweep of docs/ensemble.md,
   `two_stream` at its registry size with `--sweep drift=0.1,0.2,0.3
   --ensemble 4` (12 members, one bucket, 300 steps): every member
   bit-equal to its solo run, one read a window, one capture, the bucket's
   ms per window and host reads against the 12 solo runs back to back;
   every member's field energy within 0.5 decades (window means, linear
   phase) of the cold linear solution of its own seed, and its fitted
   growth within 0.75-1.25 of the seeded mode's analytic rate wherever the
   same fit finds that rate in the linear solution (the drift-0.2
   replicas: at 0.1 and 0.3 the fit's window opens on the velocity seed's
   transient, in the linear solution as well);
   (c) growth isolation, tests/test_torch_ensemble.py's members (6^3,
   order 1, capacity 12, one hot member at u_th 0.5, two mild at 0.02, 28
   steps, window 7): the hot member bit-equal to its solo run, which grows
   the same way, the mild siblings bit-equal to solo runs that never grow,
   each fused kernel giving the same bits at capacities 12 and 24 with the
   same occupied slots, captures one plus one a growth;
   (d) member checkpoints at 32^3: `save_member(1)` at step 8,
   `load_simulation` and 4 more steps bit-equal to the bucket continuing,
   and the same checkpoint restored into a fresh bucket, bit-equal;
17. the simulation service at 32^3, order 3 (`SimService(max_batch=4)`):
   four jobs of one signature make one batch and one capture, four more
   none (a cache hit) and the same results, a job at order 2 its own
   capture; jobs per second and ms per member-step; with `cache_size=1` a
   second signature evicts the first, whose window and graph must then be
   gone (weak references), with the memory reserved before and after;
18. the gradient subsystem: (a) the default `pic_fit` problem, lwfa at its
   registry size (8x8x64, ppc 2^3, cap 48), 60 differentiated steps,
   `laser.a0`, `injected_charge`, ``remat="step"``, 8 AdamW iterations:
   every gradient finite, the loss lower at the end, one set-up, every
   dispatcher resolution ``torch`` and no kernel launched; ms per
   iteration, value-and-grad over forward, peak memory; the diff window's
   forward at the initial params bit-equal to the captured windowed run on
   backend ``torch`` from the same state; (b) `injected_charge` at the
   fitted params on the production path (``auto``: #3 and the deposition
   kernel the autotune picks) within 1e-3 relative of the diff window's;
   (c) lwfa at 32x32x256 (2.1 M particles), value-and-grad for
   ``remat="step"`` at 10, 20 and 40 steps, ``"chunk"`` (10) at 20 and
   ``"none"`` at 10: peak memory and ms each, the ``"step"`` peak flat
   within 10%, ``"none"`` above it, the policies' grads within 1e-5;
19. the distributed driver, its shards held on the card: (a) the main cell
   on a 4x2 mesh (`make_simulation(scenario("uniform", **MAIN,
   mesh="4x2"))`, local blocks 32x64x128, ``mig_cap`` sized from the face
   flux): one capture, 1.00 host read a window, no growth, each resolved
   kernel launched once a shard a step (8 a step); ms/step, peak memory,
   the migrated particles and payload bytes a step; ``n_alive`` exact and
   the energies and every history row within 1e-4 of the total, the field
   energy within 1e-4 of itself and every field component within 1e-4 of
   its largest magnitude against a single-device run that repeats phase
   4's bit for bit; the resolved kernels held against their plain versions
   on every shard's inputs at the local shape; the serialized and the
   overlapped exchanges timed there, bit-equal; (b) lwfa at its registry
   size on 2x2, within 1e-3 of its single-device run (energies and
   fields), its shards' kernels held as in (a); (c) at 32^3, order 3,
   4x2, the overlapped halo exchange bit-equal to the serialized one, the
   shards' kernels held as in (a), and (d) compressed migration conserving
   charge exactly, losing no particle, 16 of 28 bytes a row; (e) both
   growth hatches from ``mig_cap`` 1 and capacity 8 on a hot plasma, and
   the forced-imbalance rebalance re-splitting the mesh with no particle
   or charge lost and energies within 1e-3 of the fixed split; (f) the
   sentinel on,
   ``nan_field`` rolled back, ``recv_drop`` replayed (one discarded step,
   ``n_local`` doubled) and a crash restored from its autosave, each
   bit-equal to the clean run, and a checkpoint at step 10 loaded and
   resumed bit-equal;
20. the language-model stack (no kernel of its own: plain PyTorch ops),
   TF32 off: (a) every architecture's smoke config in float32, parameters
   from one seed on the CPU copied to the card: the forward over 16 tokens,
   a block prefill of 8 and 8 one-token decode steps, each pass's logits on
   the card within 1e-4 of the CPU's largest and every MoE dispatch (expert
   ids, slot_token, a_slot, fits) equal to the CPU's; (b) phi3-mini-3.8b and
   deepseek-moe-16b at their published widths (vocabulary, d_ff, the 64
   experts) cut to one period, float32, batch 2: the forward over 20
   tokens, a block prefill of 16 and 4 one-token steps within 1e-3 of the
   CPU's largest logit, and the share of MoE assignments that differ; (c)
   the two full configs in bfloat16 (32 and 28 layers), parameters made on
   the card from a seed, one after the other: batch 4, prompt 128, 32
   tokens through `repro_torch.launch.serve.generate`, twice: prefill ms,
   decode ms a step, tokens/s and peak memory, every logit finite, both
   runs' greedy tokens identical, and for phi3 (nothing dropped) the last
   step's logits within 5e-2 of the largest of the forward's over the same
   tokens;
21. language-model training (plain PyTorch ops, no kernel of the port's),
   TF32 off: (a) every architecture's smoke config, 3 float32 train steps
   (`repro_torch.train.make_train_step`) on the card and on the CPU from
   the same initial state and batches: loss, grad norm and MoE load
   balance within 1e-4 relative each step; the parameters within twice
   the sum of the steps' learning rates everywhere (an early Adam step
   moves a parameter by about lr * sign(g), and a gradient near 0 can flip
   sign) and within 1e-4 of each leaf's largest at all but 0.5% of it; (b)
   tests/test_training.py's ``tiny`` and ``tiny_moe`` on the card: two
   straight 10-step runs bit-equal, a `Supervisor` run with async saves
   every 2 steps and a failure injected at step 6 bit-equal to them, and
   30 supervised steps taking the loss below 0.8 (``tiny``) and 0.9
   (``tiny_moe``) of the first; (c) the two deterministic backwards at
   full-width shapes, each run 3 times and bit-equal: the embedding's
   (8192 Zipf ids into phi3-mini-3.8b's 32064 x 3072 table, bf16) and the
   MoE dispatch gather's (deepseek-moe-16b's train shape, 2 x 4096 tokens,
   top-6 of 64 experts, bf16), each timed beside the atomic route it
   replaced, whose differing elements across 3 runs are printed; (d)
   phi3-mini-3.8b at full width (32 layers, bf16 parameters, float32 AdamW
   moments), train_4k's sequence 4096 at batch 2, remat, 6 steps through
   the `Supervisor` (its checkpoint manager writes nothing here: saves are
   held bit for bit at (b)'s sizes): ms a step, tokens/s, peak memory,
   model TFLOP/s (4 x `launch.flops.forward_flops` over the step time) and
   its share of the dense bf16 peak, the 6 losses, every one finite and
   the last below the first; then one step with two microbatches from that
   state, its ms and peak. No dispatcher resolution runs a plain version
   on the card in this phase.

Every ``auto`` path resolves through the dispatcher, into a fresh cache
file made for the run; on the card ``auto`` picks among the kernels only.
Where a phase holds an ``auto`` run's launch counts, it holds them to the
backends the dispatcher resolved, prints them, and fails if an op of the
path resolved to no kernel; from phase 4 on, every phase fails if a
dispatcher resolution ran a plain PyTorch version on the card, except
phase 6's forced ``torch``, phase 14's ladder, which must, and phase 18's
differentiated paths, which run the ``torch`` route as the reference
differentiates only its ``xla`` route (the kernels have no backward): the
count is reset after phase 18 as after phase 14.

The packed deposition's plain version is evaluated on the CPU wherever the
kernel is held to it bit for bit: PyTorch on CUDA divides by a Python
scalar as a multiply by its rounded reciprocal, so the third-order spline's
t^3 / 6 can differ there by one rounding from the kernel's (and the CPU's)
division.

It prints the `kernels` JSON line, then, last, the device line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# H100 SXM data sheet, dense, at its 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12      # float32 on the CUDA cores (the kernels use no tensor cores)
PEAK_BF16_FLOPS = 989e12     # dense bfloat16 on the tensor cores (phase 21's model TFLOP/s share)
FLOPS_PER_TAP = 8            # one B-spline tap: offset, |u|, branch, polynomial

RTOL = ATOL = 1e-5           # kernel vs plain version: float32, different summation order
# kernels whose every instance must compile without spilling, and how
# many instances each has (orders 1-3; the unfused gather's N templates;
# the unfused deposition's M templates and run-time M, in both types)
NO_SPILLS = {"fused_deposit_kernel": 3, "fused_deposit_reduced_kernel": 3, "fused_gather_kernel": 3,
             "bin_gather_kernel": 8, "bin_outer_product_kernel": 10}
MAIN = dict(grid=(128, 128, 128), ppc=2, order=3, steps=32, window=16)
DIST_MESH = (4, 2)           # phase 19: the main cell's shards, all on the one card
UNFUSED = dict(MAIN, steps=8, window=8, deposition="matrix_unfused", gather="matrix_unfused")
SCATTER = dict(MAIN, steps=4, window=4, deposition="scatter", gather="scatter")
# segment_accumulate at two language-model shapes (src/repro/configs):
# the MoE combine of mixtral_8x22b (8192 tokens, top-2 experts, d_model
# 6144: one bin per token, capacity 2) and the embedding gradient of
# phi3_mini_3p8b (8192 token ids, Zipf-like over its 32064-entry vocabulary,
# capacity 16, d_model 3072: the most frequent ids overflow their bins)
MOE = dict(tokens=8192, top_k=2, d=6144)
EMBED = dict(tokens=8192, vocab=32064, capacity=16, d=3072)
# phase 20: the language-model stack (src/repro_torch/models, configs)
LM_SMOKE_SEED = 0
LM_FULL = dict(batch=4, prompt=128, tokens=32)     # phase 20(c): each full config's serving run
LM_ONE_PERIOD = ("phi3-mini-3.8b", "deepseek-moe-16b")
# phase 21: LM training. Full width: phi3-mini-3.8b at train_4k's sequence
# (configs/shapes.py), its global batch of 256 cut to the 2 one card holds
LM_TRAIN_FULL = dict(arch="phi3-mini-3.8b", batch=2, seq=4096, steps=6)
LM_TRAIN_SMOKE_STEPS = 3


# the kernel that a dispatcher op's backend launches once a step
KERNEL_OF = {("deposit_fused", "cuda_reduced"): "fused_bin_deposit_reduced", ("deposit_fused", "cuda"): "fused_bin_deposit",
             ("gather_fused", "cuda"): "fused_bin_gather"}
FUSED = ("fused_bin_deposit", "fused_bin_deposit_reduced", "fused_bin_gather")
ROOT = Path(__file__).resolve().parent
AUTOTUNE_CACHE = ROOT / "build" / "chip_smoke_autotune.json"


def say(*args):
    print(*args, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(torch, fn, reps: int) -> float:
    """Mean device time of one call, by CUDA events over `reps` calls after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_err(torch, got, want) -> float:
    """Largest |got - want|; fails beyond atol + rtol * |want|."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    if not bool(torch.isfinite(got).all()):
        fail("kernel output is not finite")
    bad = diff > ATOL + RTOL * want.abs()
    if bool(bad.any()):
        fail(f"kernel disagrees with its plain version: {int(bad.sum())} elements, max |diff| {float(diff.max()):.3e}")
    return float(diff.max())


def exact(torch, got, want_cpu) -> float:
    """0.0 if got is bit-equal to want_cpu (a plain version evaluated on the
    CPU); fails otherwise."""
    if not torch.equal(got.cpu(), want_cpu):
        diff = (got.cpu() - want_cpu).abs()
        fail(f"kernel is not bit-equal to its plain version: {int((diff > 0).sum())} elements differ, "
             f"max |diff| {float(diff.max()):.3e}")
    return 0.0


def bound(n_bytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ptxas_report(log: str) -> dict[str, tuple[int, int]]:
    """(registers, spill stores + loads in bytes) per compiled entry
    function, from ptxas -v output."""
    out, fn, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            out[fn] = (int(m.group(1)), spill)
            fn, spill = None, 0
    return out


def synthetic_slab(torch, grid, cap, gen, dev, *, empty=(), full=()):
    """A slab with a random occupancy per cell (cells ``empty`` hold no
    particle, ``full`` fill every slot); gap slots get val 0 and the offset
    of one aliased particle from their cell, as the port's slabs do."""
    n_cells = math.prod(grid)
    occ = torch.randint(0, cap + 1, (n_cells,), generator=gen, device=dev)
    occ[list(empty)] = 0
    occ[list(full)] = cap
    d = torch.rand((n_cells, cap, 3), generator=gen, device=dev)
    val = torch.randn((n_cells, cap, 3), generator=gen, device=dev)
    gap = torch.arange(cap, device=dev)[None, :] >= occ[:, None]
    val[gap] = 0.0
    idx = torch.arange(n_cells, device=dev)
    cells = torch.stack((idx // (grid[1] * grid[2]), (idx // grid[2]) % grid[1], idx % grid[2]), -1).float()
    alias = torch.rand(3, generator=gen, device=dev) * torch.tensor(grid, dtype=torch.float32, device=dev)
    d = torch.where(gap[..., None], (alias - cells)[:, None, :], d)
    return d.contiguous(), val.contiguous()


def run_path(torch, kernels, sim, label: str, n_steps: int | None = None, warmup: int = 0) -> dict:
    """Run a simulation from launch counts at 0, print its step time (with
    and without the CUDA graph's one-time set-up: a warm-up step and the
    capture), rate, peak memory, host reads and launches, and fail unless
    every window made one host read (two more per capacity growth). With
    ``warmup``, a first window of that many steps runs untimed (its
    launches and reads counted) and the steady state is the run after it;
    the time with the set-up then spans both."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n0 = sim.diagnostics()["n_alive"]
    kernels.reset_launch_counts()
    reads0, windows0, setup0, step0 = sim.host_reads, sim.windows, sim.graph_setup_seconds, sim.state.step
    t0 = time.perf_counter()
    if warmup:
        sim.run(warmup)
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    sim.run(n_steps)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    steps = sim.state.step - step0
    timed = steps - warmup
    setup_s = sim.graph_setup_seconds - setup0
    windows, reads = sim.windows - windows0, sim.host_reads - reads0
    steady_s = t2 - t1 if warmup else t2 - t0 - setup_s
    out = dict(run_s=t2 - t0, setup_s=setup_s, steps=steps, n0=n0, counts=counts, captures=sim.graph_captures,
               ms_step=1e3 * steady_s / timed, ms_step_setup=1e3 * (t2 - t0) / steps,
               rate=n0 * timed / steady_s, reads_per_window=reads / max(windows, 1),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    say(f"{label}: {n0} particles, {steps} steps in {t2 - t0:.3f} s: {out['ms_step_setup']:.2f} ms/step with the "
        f"graph's set-up ({setup_s:.3f} s, {sim.graph_captures} capture(s)), {out['ms_step']:.2f} ms/step without"
        f"{f' (the {timed} steps after a {warmup}-step warm-up window)' if warmup else ''}, "
        f"{out['rate']:.4e} particle-steps/s")
    say(f"  peak memory {out['peak_gb']:.2f} GB, host reads {reads} in {windows} windows "
        f"({out['reads_per_window']:.2f}/window), sorts {sim.sorts}, rebuilds {sim.rebuilds}, "
        f"growths {sim.growths['capacity']}, launches {counts} (each capture's warm-up step launches once more)")
    if reads != windows + 2 * sim.growths["capacity"]:
        fail(f"{label}: {reads} host reads in {windows} windows with {sim.growths['capacity']} growths: "
             "expected one a window, two more a growth")
    return out


def resolved(dispatch, sim) -> dict[str, str]:
    """The backend of each dispatcher op of a driver's step, as the step
    resolves it (from the memo: the driver resolved its keys at set-up)."""
    c = sim.config
    return dispatch.prewarm(dispatch.ops_for_modes(c.deposition, c.gather), device=sim.device, order=c.order,
                            grid_shape=c.grid.shape, capacity=c.capacity, dtype=sim.state.particles.pos.dtype,
                            requested=c.backend)


def path_launches(chosen: dict[str, str], n: int) -> dict[str, int]:
    """The fused kernels' launches in n steps under the resolved backends:
    one entry per dispatcher op of the step, each of which must have
    resolved to a kernel."""
    plain = {op: b for op, b in chosen.items() if (op, b) not in KERNEL_OF}
    if plain:
        fail(f"the dispatcher resolved {plain} to no kernel on the card")
    return {KERNEL_OF[kv]: n for kv in chosen.items()}


def no_plain(dispatch, where: str) -> None:
    """Fail if a dispatcher resolution since the counter was last zeroed
    handed the card's tensors to a plain PyTorch version (a forced
    ``torch`` or a demotion to it)."""
    n = dispatch.counters["plain_on_card"]
    if n:
        fail(f"{where}: {n} dispatcher resolution(s) ran a plain PyTorch version on the card")


def fused_counts(counts: dict[str, int]) -> dict[str, int]:
    return {k: counts[k] for k in FUSED if counts.get(k)}


def host_copy(sim):
    """The driver's counters, state and policy state with every tensor
    copied to the host: a stand-in for the driver in `same_state`."""
    import dataclasses
    import types

    def cpu(tree):
        return None if tree is None else dataclasses.replace(
            tree, **{f.name: getattr(tree, f.name).cpu() for f in dataclasses.fields(tree)})

    state = dataclasses.replace(sim.state, **{part: cpu(getattr(sim.state, part))
                                              for part in ("fields", "particles", "layout", "slab")})
    return types.SimpleNamespace(sorts=sim.sorts, rebuilds=sim.rebuilds, growths=dict(sim.growths), state=state,
                                 policy_state=cpu(sim.policy_state), history=list(sim.history))


def same_state(torch, a, b, *, policy: bool = True) -> bool:
    """Two drivers' states, counters and (with ``policy``) device policy
    states bit for bit, on the host (a driver or its `host_copy`). The
    host-driven loop keeps its policy on the host, so its device policy
    state is not compared."""
    import dataclasses

    if (a.sorts, a.rebuilds, a.growths, a.state.step) != (b.sorts, b.rebuilds, b.growths, b.state.step):
        return False
    for part in ("fields", "particles", "layout", "slab"):
        x, y = getattr(a.state, part), getattr(b.state, part)
        if (x is None) != (y is None):
            return False
        if x is not None and not all(torch.equal(getattr(x, f.name).cpu(), getattr(y, f.name).cpu())
                                     for f in dataclasses.fields(x)):
            return False
    return not policy or all(torch.equal(getattr(a.policy_state, f.name).cpu(), getattr(b.policy_state, f.name).cpu())
                             for f in dataclasses.fields(a.policy_state))


def energy_slope(np, history, dt: float) -> float:
    """d ln(field energy)/dt fitted over the linear growth: past 100x the
    smallest energy, before 10% of the largest (tests/test_scenarios.py)."""
    t = np.array([h["step"] for h in history]) * dt
    e = np.array([h["field_energy"] for h in history])
    if not np.isfinite(e).all():
        fail("growth run: field energy not finite")
    lo, hi = e.min(), e.max()
    if hi <= 1e3 * lo:
        fail(f"growth run: no exponential growth, energy {lo:.2e}..{hi:.2e}")
    idx = np.where((e > lo * 100) & (e < hi * 0.1))[0]
    if len(idx) < 10:
        fail(f"growth run: linear window too short ({len(idx)} samples)")
    i0, i1 = idx[0], idx[-1]
    return float(np.polyfit(t[i0:i1 + 1], np.log(e[i0:i1 + 1]), 1)[0])


def member_view(bucket, i):
    """Member i of an ensemble bucket as a stand-in for a driver in
    `same_state`: its counters, state and policy state (views of the
    bucket's tensors)."""
    import types

    return types.SimpleNamespace(sorts=int(bucket.sorts[i]), rebuilds=int(bucket.rebuilds[i]),
                                 growths=dict(bucket.growths), state=bucket.member_state(i),
                                 policy_state=bucket.member_policy_state(i), history=bucket.histories[i])


def lattice_members(torch, np, specs, dev, shape=(6, 6, 6)):
    """tests/test_torch_ensemble.py's members: lattice plasmas, 2^3 a cell,
    numpy thermal momenta, one (fields, particles) pair per (seed,
    u_thermal)."""
    from repro_torch.pic import FieldState, ParticleState

    off = (np.arange(2) + 0.5) / 2
    cells = np.stack(np.meshgrid(*(np.arange(n) for n in shape), indexing="ij"), -1).reshape(-1, 1, 3)
    lattice = np.stack(np.meshgrid(off, off, off, indexing="ij"), -1).reshape(1, -1, 3)
    pos = (cells + lattice).reshape(-1, 3).astype(np.float32)
    out = []
    for seed, u_thermal in specs:
        u = (u_thermal * np.random.default_rng(seed).normal(size=pos.shape)).astype(np.float32)
        out.append((FieldState.zeros(shape, device=dev),
                    ParticleState(pos=torch.from_numpy(pos).to(dev), u=torch.from_numpy(u).to(dev),
                                  w=torch.full((len(pos),), 1 / 8, device=dev),
                                  alive=torch.ones(len(pos), dtype=torch.bool, device=dev))))
    return out


def ensemble_phase(torch, np, kernels, dispatch, dev, main, main_final, chosen, dep, gat) -> None:
    """Phase 16: ensembles on the card (see the module docstring)."""
    import shutil

    from repro_torch.api import (
        EnsembleSpec,
        SortPolicyConfig,
        load_simulation,
        make_ensemble,
        make_simulation,
        scenario,
        two_stream_growth_rate,
        two_stream_linear_energy,
    )
    from repro_torch.core import max_guard
    from repro_torch.launch.pic_run import parse_sweeps
    from repro_torch.pic import EnsembleSimulation, GridSpec, PICConfig, Simulation

    # (a) the main path at full width, two members in one bucket
    es = EnsembleSpec.replicate(scenario("uniform", **MAIN), 2)
    members = es.members()
    if members[0].plasma.seed != scenario("uniform", **MAIN).plasma.seed:
        fail("the first replica does not have phase 4's seed")
    solo = make_simulation(members[1])
    solo.run()
    solo_final = host_copy(solo)
    del solo
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t1 = time.perf_counter()
    ens = make_ensemble(es)
    bucket = ens.sims[0]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ens.run()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    member_steps = int(bucket.host_step.sum())
    ms_ms = 1e3 * (t3 - t2 - bucket.graph_setup_seconds) / member_steps
    peak = torch.cuda.max_memory_allocated() / 1e9
    reads_w = bucket.host_reads / bucket.windows
    per_ms = {k: (counts.get(k, 0) - bucket.graph_captures) / member_steps for k in FUSED if counts.get(k)}
    equal = [same_state(torch, member_view(bucket, 0), main_final),
             same_state(torch, member_view(bucket, 1), solo_final)]
    say(f"ensemble (a), 2 x uniform {MAIN['grid']}, order {MAIN['order']}: {member_steps} member-steps, "
        f"{ms_ms:.2f} ms/member-step against phase 4's {main['ms_step']:.2f} ms/step "
        f"({ms_ms / main['ms_step']:.3f}x), set-up {t2 - t1:.2f} s build + {bucket.graph_setup_seconds:.2f} s "
        f"capture, peak {peak:.2f} GB (phase 4: {main['peak_gb']:.2f}), host reads {bucket.host_reads} in "
        f"{bucket.windows} windows ({reads_w:.2f}/window), captures {bucket.graph_captures}, launches {counts} "
        f"({per_ms} per member-step, the capture's warm-up step aside), bit-equal to the solo runs: {equal} "
        f"(member 0: phase 4's run)")
    if not all(equal) or reads_w != 1.0 or bucket.graph_captures != 1:
        fail("ensemble (a): members not bit-equal to their solo runs, or not one host read a window and one capture")
    if counts != path_launches(chosen, member_steps + bucket.graph_captures) or set(per_ms.values()) != {1.0}:
        fail(f"ensemble (a): each member did not launch the resolved kernels {chosen} once a step: {counts}")
    del ens, bucket, solo_final
    torch.cuda.empty_cache()

    # (b) the sweep of docs/ensemble.md: two_stream, drift 0.1 / 0.2 / 0.3,
    # four replicas each, as `pic_run --sweep drift=0.1,0.2,0.3 --ensemble 4`
    es = EnsembleSpec.sweep(scenario("two_stream"), parse_sweeps(["drift=0.1,0.2,0.3"]), replicas=4)
    members = es.members()
    solo_s, solo_reads, solo_windows, solos = 0.0, 0, 0, []
    for m in members:
        sim = make_simulation(m)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sim.run()
        torch.cuda.synchronize()
        solo_s += time.perf_counter() - t1 - sim.graph_setup_seconds
        solo_reads += sim.host_reads
        solo_windows += sim.windows
        solos.append(host_copy(sim))
        del sim
    ens = make_ensemble(es)
    if len(ens.sims) != 1:
        fail(f"the sweep made {len(ens.sims)} buckets, not one")
    bucket = ens.sims[0]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ens.run()
    torch.cuda.synchronize()
    bucket_s = time.perf_counter() - t1 - bucket.graph_setup_seconds
    say(f"ensemble (b), two_stream sweep drift 0.1/0.2/0.3 x 4 replicas: {bucket.n_members} members in one bucket, "
        f"{int(bucket.host_step[0])} steps, window {members[0].run.window}: {1e3 * bucket_s / bucket.windows:.2f} "
        f"ms/window against {1e3 * solo_s / bucket.windows:.2f} for the 12 solo runs back to back "
        f"({solo_s / bucket_s:.3f}x), {1e3 * bucket_s / int(bucket.host_step.sum()):.4f} ms/member-step against "
        f"{1e3 * solo_s / int(bucket.host_step.sum()):.4f}; host reads {bucket.host_reads} in {bucket.windows} "
        f"windows against {solo_reads} in {solo_windows}; captures {bucket.graph_captures}, set-up "
        f"{bucket.graph_setup_seconds:.2f} s")
    # Each member's field energy against the cold linear solution of its own
    # seed, in window-long block means over the linear phase (below 10% of
    # the run's largest energy); and its fitted growth against the seeded
    # mode's analytic 2*gamma, where the fit finds that rate in the linear
    # solution itself (the seed's growing root rules the fit window).
    ratios, equal, anchored, deviation = [], [], [], []
    for i, m in enumerate(members):
        gamma = two_stream_growth_rate(m)
        hist = bucket.histories[i]
        equal.append(same_state(torch, member_view(bucket, i), solos[i]) and hist == solos[i].history)
        steps = [h["step"] for h in hist]
        e = np.array([h["field_energy"] for h in hist])
        lin = two_stream_linear_energy(m, steps)
        blocks = [float(np.log10(e[j:j + m.run.window].mean() / lin[j:j + m.run.window].mean()))
                  for j in range(0, len(e), m.run.window) if (e[j:j + m.run.window] < 0.1 * e.max()).all()]
        deviation.append(max(blocks, key=abs) if blocks else float("inf"))
        lin_ratio = energy_slope(np, [dict(step=s, field_energy=w) for s, w in zip(steps, lin)], m.dt) / (2 * gamma)
        ratios.append((energy_slope(np, hist, m.dt) / (2 * gamma), lin_ratio))
        anchored.append(0.75 < lin_ratio < 1.25)
    say("  each member's field energy against the cold linear solution of its seed (largest window-mean "
        "log10 deviation over the linear phase; held within 0.5), and its fitted growth against the seeded "
        "mode's analytic 2*gamma (the linear solution's own fit beside it; held to 0.75-1.25 where that is, "
        "marked *): "
        + ", ".join(f"m{i} drift {m.plasma.drift.u}: {d:+.3f}, {r:.3f} ({lr:.3f})" + ("*" if a else "")
                    for i, (m, d, (r, lr), a) in enumerate(zip(members, deviation, ratios, anchored)))
        + f"; each member bit-equal to its solo run: {equal}")
    if not any(anchored) or any(a and not 0.75 < r < 1.25 for (r, _), a in zip(ratios, anchored)):
        fail("ensemble (b): no member's fit can find the analytic rate, or a member's growth ratio is outside "
             "0.75-1.25 where the linear solution's is inside")
    if any(abs(d) > 0.5 for d in deviation):
        fail("ensemble (b): a member's field energy strays more than 0.5 decades from the linear solution")
    if not all(equal) or bucket.host_reads != bucket.windows or bucket.graph_captures != 1:
        fail("ensemble (b): a member is not bit-equal to its solo run, or not one read a window and one capture")
    del ens, bucket, solos

    # (c) growth isolation: tests/test_ensemble.py's members (6^3, order 1,
    # capacity 12, one hot member, two mild), 28 steps in windows of 7
    specs = [(0, 0.5), (1, 0.02), (2, 0.02)]
    interval_only = SortPolicyConfig(sort_interval=10, sort_trigger_perf_enable=False, sort_trigger_empty_ratio=2.0,
                                     sort_trigger_full_ratio=2.0, sort_trigger_rebuild_count=10**6)
    cfg = PICConfig(grid=GridSpec(shape=(6, 6, 6)), dt=0.2, order=1, capacity=12)
    ens = EnsembleSimulation(lattice_members(torch, np, specs, dev), cfg, interval_only)
    ens.run(28, window=7)
    report = []
    for i, member in enumerate(lattice_members(torch, np, specs, dev)):
        solo = Simulation(*member, cfg, policy=interval_only)
        solo.run(28, window=7)
        if (i == 0) != (solo.growths["capacity"] > 0):
            fail(f"ensemble (c): member {i}'s solo run grew {solo.growths['capacity']} times")
        if i == 0:
            ok = same_state(torch, member_view(ens, 0), solo)
            report.append(f"hot member bit-equal to its solo run (capacity {solo.config.capacity}): {ok}")
            if not ok:
                fail("ensemble (c): the hot member is not bit-equal to its solo run")
            continue
        # a sibling shares the growth but not the sort: the kernels give the
        # same bits at any capacity, so it must stay bit-equal to its solo run
        st, so = ens.member_state(i), solo.state
        diffs = {}
        for part in ("fields", "particles"):
            for name in getattr(st, part).__dataclass_fields__:
                a, b = getattr(getattr(st, part), name), getattr(getattr(so, part), name)
                diffs[f"{part}.{name}"] = 0.0 if torch.equal(a, b) else (
                    float("inf") if a.dtype == torch.bool else float((a - b).abs().max()))
        report.append(f"sibling {i} (solo capacity {solo.config.capacity}) bit-equal: "
                      f"{all(d == 0.0 for d in diffs.values())} (max |diff| {max(diffs.values()):.3e})")
        if any(diffs.values()):
            fail(f"ensemble (c): sibling {i} is not bit-equal to its solo run: "
                 + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items() if v))
        if (int(ens.sorts[i]), int(ens.rebuilds[i]), ens.member_state(i).step) != \
                (solo.sorts, solo.rebuilds, solo.state.step):
            fail(f"ensemble (c): sibling {i}'s sorts, rebuilds or steps differ from its solo run's")
    say(f"ensemble (c), growth isolation: capacity 12 -> {ens.config.capacity}, growths {ens.growths['capacity']}, "
        f"halts {ens.halts}, captures {ens.graph_captures}, host reads {ens.host_reads} in {ens.windows} windows; "
        + "; ".join(report))
    if ens.growths["capacity"] < 1 or ens.graph_captures != 1 + ens.growths["capacity"]:
        fail("ensemble (c): no growth, or captures other than one plus one a growth")
    # the kernels at a capacity and at twice it, the same occupied slots: a
    # kernel that regroups with the capacity shows here
    gen = torch.Generator(device=dev).manual_seed(5)
    grid = (6, 6, 6)
    g = max_guard(1)
    d, val = synthetic_slab(torch, grid, 12, gen, dev)
    d2 = torch.cat([d, d[:, :1].expand(-1, 12, -1)], dim=1).contiguous()
    val2 = torch.cat([val, torch.zeros_like(val)], dim=1).contiguous()
    padded = torch.randn((6, *(k + 2 * g for k in grid)), generator=gen, device=dev)
    occupied = val.abs().sum(-1) != 0
    probe = {
        "fused_bin_deposit": torch.equal(dep.fused_bin_deposit(d, val, order=1), dep.fused_bin_deposit(d2, val2, order=1)),
        "fused_bin_deposit_reduced": torch.equal(
            dep.fused_bin_deposit_reduced(d, val, order=1, grid_shape=grid, guard=g),
            dep.fused_bin_deposit_reduced(d2, val2, order=1, grid_shape=grid, guard=g)),
        "fused_bin_gather": torch.equal(
            gat.fused_bin_gather(d, padded, grid_shape=grid, order=1, guard=g)[occupied],
            gat.fused_bin_gather(d2, padded, grid_shape=grid, order=1, guard=g)[:, :12][occupied]),
    }
    say(f"  the kernels at capacity 12 and 24, same occupied slots, bit-equal: {probe}")
    if not all(probe.values()):
        fail(f"ensemble (c): a kernel regroups its sums with the capacity: {probe}")
    del ens

    # (d) member checkpoints at 32^3
    ckpt = ROOT / "build" / "chip_smoke_member"
    try:
        es = EnsembleSpec.replicate(scenario("uniform", grid=(32, 32, 32), ppc=2, order=3, steps=8, window=4,
                                             diagnostics_every=1), 2)
        ens = make_ensemble(es)
        ens.run()
        ens.save_member(1, str(ckpt))
        loaded = load_simulation(str(ckpt))
        loaded.run(4)
        ens.run(4)
        b, s_ = ens.slot(1)
        ok_load = same_state(torch, member_view(ens.sims[b], s_), loaded) and ens.history(1) == loaded.history
        fresh = make_ensemble(es)
        fresh.restore_member(1, str(ckpt))
        fresh.run(4)
        fb, fs = fresh.slot(1)
        ok_restore = same_state(torch, member_view(fresh.sims[fb], fs), member_view(ens.sims[b], s_)) and \
            fresh.history(1) == ens.history(1)
        say(f"ensemble (d), member checkpoints at 32^3: save_member(1) at step 8, load_simulation, 4 more steps "
            f"bit-equal to the bucket continuing: {ok_load}; restored into a fresh bucket and run 4 steps, "
            f"bit-equal: {ok_restore}")
        if not (ok_load and ok_restore):
            fail("ensemble (d): a member checkpoint did not continue bit for bit")
        del ens, loaded, fresh
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


def service_phase(torch, dev) -> None:
    """Phase 17: the simulation service on the card (see the module
    docstring)."""
    import asyncio
    import gc
    import weakref

    from repro_torch.api import apply_overrides, scenario, spec_signature
    from repro_torch.launch.sim_serve import SimService

    spec = scenario("uniform", grid=(32, 32, 32), ppc=2, order=3, steps=16, window=8)
    other = apply_overrides(spec, order=2)

    async def drain(svc, ids):
        finals = {}
        for job_id in ids:
            async for event in svc.results(job_id):
                finals[job_id] = event
        return [finals[j] for j in ids]

    async def body():
        out = {}
        svc = SimService(max_batch=4, batch_wait=0.5)
        await svc.start()
        for label, s_, n in (("first", spec, 4), ("repeat", spec, 4), ("order 2", other, 1)):
            caps0, builds0 = svc.graph_captures, svc.window_builds
            t1 = time.perf_counter()
            finals = await drain(svc, [await svc.submit(s_.to_json()) for _ in range(n)])
            secs = time.perf_counter() - t1
            out[label] = dict(finals=finals, secs=secs, captures=svc.graph_captures - caps0,
                              builds=svc.window_builds - builds0, member_steps=n * s_.run.steps)
        out["stats"] = svc.cache.stats()
        await svc.close()
        # eviction: a cache of one signature, a second signature evicts the first
        small = SimService(max_batch=4, batch_wait=0.25, cache_size=1)
        await small.start()
        await drain(small, [await small.submit(spec.to_json()) for _ in range(4)])
        window = small.cache._entries[spec_signature(spec)][4]
        refs = [weakref.ref(window)] + ([] if window.graph is None else [weakref.ref(window.graph)])
        del window
        gc.collect()
        torch.cuda.empty_cache()
        reserved_before = torch.cuda.memory_reserved(dev)
        await drain(small, [await small.submit(other.to_json())])
        gc.collect()
        torch.cuda.empty_cache()
        out["evict"] = dict(alive=[r() is not None for r in refs], stats=small.cache.stats(),
                            reserved_before=reserved_before, reserved_after=torch.cuda.memory_reserved(dev))
        await small.close()
        return out

    out = asyncio.run(body())
    for label in ("first", "repeat", "order 2"):
        o = out[label]
        ok = all(f["event"] == "done" and f["diagnostics"]["step"] == 16 for f in o["finals"])
        sizes = sorted({f["batch_size"] for f in o["finals"]})
        say(f"service, {label}: {len(o['finals'])} job(s) in batches of {sizes}, {o['secs']:.3f} s, "
            f"{len(o['finals']) / o['secs']:.2f} jobs/s, {1e3 * o['secs'] / o['member_steps']:.3f} ms/member-step "
            f"(set-up included), captures {o['captures']}, windows built {o['builds']}, all done: {ok}")
        if not ok:
            fail(f"service, {label}: a job did not finish its 16 steps")
    if [out[k]["captures"] for k in ("first", "repeat", "order 2")] != [1, 0, 1] or \
            {f["batch_size"] for f in out["first"]["finals"] + out["repeat"]["finals"]} != {4}:
        fail("service: expected one batch of 4 and one capture, then a cache hit with none, then one for order 2")
    if [f["history"] for f in out["repeat"]["finals"]] != [f["history"] for f in out["first"]["finals"]] or \
            [f["diagnostics"] for f in out["repeat"]["finals"]] != [f["diagnostics"] for f in out["first"]["finals"]]:
        fail("service: the repeat batch did not reproduce the first batch's results")
    ev = out["evict"]
    say(f"service cache {out['stats']}; with cache_size=1 a second signature evicts the first: its window and "
        f"graph still alive {ev['alive']}, cache {ev['stats']}, memory reserved {ev['reserved_before'] / 1e9:.3f} "
        f"-> {ev['reserved_after'] / 1e9:.3f} GB")
    if any(ev["alive"]) or ev["stats"]["evictions"] != 1:
        fail("service: evicting a signature did not free its window and graph")


def grad_phase(torch, kernels, dispatch, dev) -> None:
    """Phase 18: the gradient subsystem on the card (see the module
    docstring). Its paths run the plain ``torch`` route on the card, as the
    reference differentiates only its ``xla`` route: the counter of plain
    resolutions is not held to 0 here, and the caller resets it after."""
    import dataclasses

    from repro_torch.api import GradSpec, fit_simulation, make_objective, make_simulation, pic_config, scenario
    from repro_torch.core import policy_init
    from repro_torch.grad import get_objective
    from repro_torch.grad.params import StateBuilder
    from repro_torch.pic.simulation import Simulation, run_window_diff

    log = []
    resolve = dispatch.resolve

    def logged(*args, **kw):
        name = resolve(*args, **kw)
        log.append((args[0], name))
        return name

    def value_and_grad(loss_fn, params):
        leaves = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
        loss, aux = loss_fn(leaves)
        loss.backward()
        return float(loss.detach()), float(aux["objective"].detach()), {k: v.grad.clone() for k, v in leaves.items()}

    def timed(fn):
        """fn's result, its ms, and its peak memory: the most allocated
        during the call above what was allocated at its start (what earlier
        phases still hold is not the call's)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t1), (torch.cuda.max_memory_allocated() - base) / 1e9

    # (a) the default pic_fit problem: lwfa at its registry size, 60 steps
    spec = scenario("lwfa")
    gspec = GradSpec()
    dispatch.resolve = logged
    kernels.reset_launch_counts()
    try:
        fit, fit_ms, fit_gb = timed(lambda: fit_simulation(spec, gspec, iters=8))
        loss_fn, params0 = make_objective(spec, gspec)
        with torch.no_grad():
            loss_fn(params0)  # a first forward, untimed
            _, fwd_ms, _ = timed(lambda: loss_fn(params0))
        _, vg_ms, vg_gb = timed(lambda: value_and_grad(loss_fn, params0))
    finally:
        dispatch.resolve = resolve
    launched = {k: v for k, v in kernels.launch_counts().items() if v}
    losses = [r["loss"] for r in fit.history]
    finite = all(math.isfinite(g) for r in fit.history for g in r["grads"].values())
    say(f"fit, lwfa {spec.grid.shape}, {spec.run.steps} differentiated steps, remat {gspec.remat}, 8 AdamW "
        f"iterations: {fit_ms / 8:.1f} ms/iteration, peak memory {fit_gb:.3f} GB; loss {losses[0]:.6g} -> "
        f"{losses[-1]:.6g}, laser.a0 {fit.history[0]['params']['laser.a0']:.5g} -> {fit.params['laser.a0']:.5g}, "
        f"grads finite {finite}, compiles {fit.compiles}")
    say(f"  forward {fwd_ms:.1f} ms, value-and-grad {vg_ms:.1f} ms ({vg_ms / fwd_ms:.2f}x the forward, peak "
        f"{vg_gb:.3f} GB); resolutions {sorted(set(log))}, kernel launches {launched}")
    if not finite or not losses[-1] < losses[0] or fit.compiles != 1:
        fail("the fit: a non-finite gradient, no decrease of the loss, or more than one set-up")
    if not log or any(name != "torch" for _, name in log) or launched:
        fail(f"the differentiated path resolved {sorted(set(log))} and launched {launched}: expected torch only")

    # the diff window's forward at the initial params, bit for bit against
    # the captured windowed run on the torch route from the same state
    config = dataclasses.replace(pic_config(spec), backend="torch")
    builder = StateBuilder(spec, config)
    with torch.no_grad():
        state = builder.build(params0)
        diff_state, diff_pstate, bundle = run_window_diff(state, policy_init(dev), builder.config,
                                                          spec.run.steps, policy=spec.sort.policy)
    sim = Simulation(state.fields, state.particles, builder.config, policy=spec.sort.policy)
    sim.run(spec.run.steps, window=spec.run.window)
    same = (sim.graph_captures == 1 and (sim.sorts, sim.rebuilds) == (bundle["n_sorts"], bundle["n_rebuilds"])
            and all(torch.equal(getattr(getattr(sim.state, part), f.name), getattr(getattr(diff_state, part), f.name))
                    for part in ("fields", "particles", "layout", "slab")
                    for f in dataclasses.fields(getattr(sim.state, part)))
            and all(torch.equal(getattr(sim.policy_state, f.name), getattr(diff_pstate, f.name))
                    for f in dataclasses.fields(diff_pstate)))
    say(f"  the diff window's forward ({bundle['n_sorts']} policy sorts, {bundle['n_rebuilds']} rebuilds) bit-equal "
        f"to the captured torch-route run ({sim.graph_captures} capture, {sim.sorts} sorts): {same}")
    if not same:
        fail("the differentiable window's forward is not bit-equal to the captured windowed run")
    del sim, builder, state, diff_state

    # (b) the objective on the production path: the fitted laser, backend auto
    objective = get_objective(gspec.objective)
    with torch.no_grad():
        _, aux = loss_fn({k: torch.tensor(v, device=dev) for k, v in fit.params.items()})
    diff_value = float(aux["objective"])
    fitted = dataclasses.replace(spec, laser=dataclasses.replace(spec.laser, a0=fit.params["laser.a0"]))
    prod = make_simulation(fitted)
    chosen = resolved(dispatch, prod)
    kernels.reset_launch_counts()
    prod.run(spec.run.steps)
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    prod_value = float(objective.fn(prod.state, None, prod.config, **gspec.okwargs))
    rel = abs(prod_value - diff_value) / abs(diff_value)
    say(f"  injected_charge at the fitted a0: diff window {diff_value:.7g}, the production path {prod_value:.7g} "
        f"(resolved {chosen}, launches {counts}): relative difference {rel:.3e}")
    if rel > 1e-3 or fused_counts(counts) != path_launches(chosen, spec.run.steps + prod.graph_captures):
        fail("the kernels' objective is more than 1e-3 from the differentiated one, or they did not run")
    del prod, loss_fn
    torch.cuda.empty_cache()

    # (c) remat at 32x32x256; the laser is far from the plasma for the
    # first 40 steps, so d/d a0 is ~0 there: the density carries the
    # comparison of the policies' grads
    big = scenario("lwfa", grid=(32, 32, 256))
    learn = ("laser.a0", "density")
    rows = {}
    dispatch.resolve = logged
    log.clear()
    try:
        for remat, n in (("step", 10), ("step", 20), ("step", 40), ("chunk", 20), ("none", 10)):
            loss_fn, p0 = make_objective(big, GradSpec(learn=learn, remat=remat, remat_chunk=10, steps=n))
            (loss, _, grads), ms, gb = timed(lambda: value_and_grad(loss_fn, p0))
            rows[(remat, n)] = dict(ms=ms, gb=gb, grad=torch.stack([grads[k] for k in learn]).double())
            say(f"remat {remat!r}{' (chunk 10)' if remat == 'chunk' else ''}, lwfa {big.grid.shape}, {n} steps: "
                f"value-and-grad {ms:.0f} ms ({ms / n:.1f} ms/step), peak memory {gb:.3f} GB, grads "
                + ", ".join(f"{k} {float(grads[k]):.9g}" for k in learn))
            del loss_fn, grads
            torch.cuda.empty_cache()
    finally:
        dispatch.resolve = resolve

    def rel(a, b):
        return float(torch.linalg.vector_norm(rows[a]["grad"] - rows[b]["grad"])
                     / torch.linalg.vector_norm(rows[b]["grad"]))

    step_gb = [rows[("step", n)]["gb"] for n in (10, 20, 40)]
    spread = max(step_gb) / min(step_gb) - 1
    rel10, rel20 = rel(("none", 10), ("step", 10)), rel(("chunk", 20), ("step", 20))
    say(f"  'step' peak from 10 to 40 steps: +{100 * spread:.1f}%; 'none' at 10 steps {rows[('none', 10)]['gb']:.3f} "
        f"against 'step' {step_gb[0]:.3f} GB; grads (relative, 2-norm): none/step at 10 steps {rel10:.2e}, "
        f"chunk/step at 20 {rel20:.2e}")
    if spread > 0.10 or not rows[("none", 10)]["gb"] > step_gb[0] or rel10 > 1e-5 or rel20 > 1e-5:
        fail("remat: 'step' memory not flat within 10%, 'none' not above it, or the policies' grads disagree")
    if any(name != "torch" for _, name in log):
        fail(f"remat: the differentiated path resolved {sorted(set(log))}")


def dist_state_equal(torch, a, b, n0=None) -> bool:
    """Two distributed drivers' states bit for bit: fields, the first ``n0``
    particle rows of each shard (a grown run appends dead padding, which
    must stay dead), and their energy histories."""
    sa, sb = a.shard_state, b.shard_state
    n0 = n0 or sa.pos.shape[2]
    if not torch.equal(sa.fields, sb.fields):
        return False
    if not all(torch.equal(getattr(sa, k)[:, :, :n0], getattr(sb, k)[:, :, :n0]) for k in ("pos", "u", "w", "alive")):
        return False
    if bool(sa.alive[:, :, n0:].any()) or bool(sb.alive[:, :, n0:].any()):
        return False
    return a.history == b.history


def energy_drift(single: dict, dist: dict) -> float:
    """Largest |single - dist| over the three energies, relative to the
    single run's total (tests/dist_sim_check.py's `_assert_energy_parity`)."""
    scale = abs(single["total_energy"]) + 1e-12
    return max(abs(single[k] - dist[k]) / scale for k in ("field_energy", "kinetic_energy", "total_energy"))


def field_drift(got, want) -> float:
    """Largest max |got - want| / max |want| over the six components (phase
    4's convention for fields that two paths sum in different orders)."""
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30) for a, b in zip(got, want))


def shard_kernels(torch, sim, chosen: dict[str, str]) -> str:
    """The resolved deposition kernel and #3 held against their plain
    versions on every shard of a distributed driver, on the inputs its shard
    body gives them at the local shape: the slab and q·w·v values staged
    from the shard's state as the step stages them, the carried slab the
    next gather reads, and the shard's block of the halo-extended fields.
    Fails on any excess (`max_err`). Its launches are not the path's: the
    caller reads the path's counts first."""
    from repro_torch.core import bin_slab_staging
    from repro_torch.core.binning import BinnedLayout
    from repro_torch.kernels.deposition import ops as dep
    from repro_torch.kernels.deposition import ref as dep_ref
    from repro_torch.kernels.gather import ops as gat
    from repro_torch.kernels.gather import ref as gat_ref
    from repro_torch.pic import lorentz_gamma
    from repro_torch.pic.distributed import _extend_all, in_domain

    cfg, st = sim.config, sim.shard_state
    shape, g, order = cfg.local_grid.shape, cfg.guard, cfg.order
    padded = _extend_all(st.fields.permute(1, 2, 0, 3, 4, 5), g, cfg).contiguous()
    v = st.u / lorentz_gamma(st.u)[..., None]
    qw = cfg.charge * st.w * (st.alive & in_domain(st.pos, shape)).to(st.w.dtype)
    reduced = chosen["deposit_fused"] == "cuda_reduced"
    dep_err = gat_err = 0.0
    sx, sy = st.pos.shape[:2]
    for a in range(sx):
        for b in range(sy):
            layout = BinnedLayout(slots=st.slots[a, b], particle_slot=st.pslot[a, b])
            slab, val = bin_slab_staging(st.pos[a, b], v[a, b], qw[a, b], layout, grid_shape=shape)
            if reduced:
                got = dep.fused_bin_deposit_reduced(slab.d, val, order=order, grid_shape=shape, guard=g)
                want = dep_ref.fused_bin_deposit_reduced_ref(slab.d, val, order=order, grid_shape=shape, guard=g)
            else:
                got = dep.fused_bin_deposit(slab.d, val, order=order)
                want = dep_ref.fused_bin_deposit_ref(slab.d, val, order=order)
            dep_err = max(dep_err, max_err(torch, got, want))
            d = st.slab_d[a, b]
            gat_err = max(gat_err, max_err(torch, gat.fused_bin_gather(d, padded[a, b], grid_shape=shape, order=order,
                                                                       guard=g),
                                           gat_ref.fused_gather_ref(d, padded[a, b], grid_shape=shape, order=order,
                                                                    guard=g)))
    dep_name = "fused_bin_deposit_reduced" if reduced else "fused_bin_deposit"
    return (f"{dep_name} and fused_bin_gather against their plain versions on each of the {sx * sy} shards at "
            f"{tuple(shape)}: max |kernel - plain| {dep_err:.2e} and {gat_err:.2e} (tolerance {ATOL} + {RTOL}*|plain|)")


def exchange_times(torch, sim, gen) -> str:
    """The serialized and the overlapped halo exchange (``comm.overlap_halo``)
    timed on a distributed driver's shards, as its step runs them: the
    guard-wide extension of the six components (``pic.halo``), the fold of
    a guard-padded current (``pic.fold``) and Maxwell's nine one-cell
    extensions. Fails unless both give the same bits."""
    import dataclasses

    from repro_torch.pic.distributed import _extend_all, _reduce_all

    cfg = sim.config
    g = cfg.guard
    fields = sim.shard_state.fields
    sx, sy = fields.shape[1:3]
    j = torch.randn((sx, sy, 3, *(n + 2 * g for n in cfg.local_grid.shape)), generator=gen, device=fields.device)
    out, parts = {}, {}
    for label, overlap in (("serialized", False), ("overlapped", True)):
        c = dataclasses.replace(cfg, comm=dataclasses.replace(cfg.comm, overlap_halo=overlap))
        jobs = {
            "halo": lambda c=c: _extend_all(fields.permute(1, 2, 0, 3, 4, 5), g, c).contiguous(),
            "fold": lambda c=c: _reduce_all(j, g, c),
            "maxwell": lambda c=c: [_extend_all(fields[k % 6], 1, c) for k in range(9)],
        }
        parts[label] = {name: fn() for name, fn in jobs.items()}
        out[label] = {name: time_ms(torch, fn, 20) for name, fn in jobs.items()}
    a, b = parts["serialized"], parts["overlapped"]
    same = (torch.equal(a["halo"], b["halo"]) and torch.equal(a["fold"], b["fold"])
            and all(torch.equal(x, y) for x, y in zip(a["maxwell"], b["maxwell"])))
    if not same:
        fail(f"the overlapped exchange is not bit-equal to the serialized one at {tuple(cfg.local_grid.shape)}")
    return ("exchanges a step on the card, serialized against overlapped, bit-equal: "
            + ", ".join(f"{name} {out['serialized'][name]:.3f} / {out['overlapped'][name]:.3f} ms"
                        for name in ("halo", "fold", "maxwell")))


def dist_phase(torch, np, kernels, dispatch, dev, main_final=None) -> None:
    """Phase 19: the distributed driver on the card (see the module
    docstring). ``main_final``: phase 4's final state, which this phase's
    single-device run must repeat bit for bit."""
    import dataclasses
    import shutil

    from repro_torch.api import build_particles, load_simulation, make_simulation, scenario
    from repro_torch.pic import DistSimulation

    def fused(counts):
        return {k: v for k, v in counts.items() if v and k in FUSED}

    def dist_resolved(sim):
        c = sim.config
        return dispatch.prewarm(dispatch.ops_for_modes(c.deposition, c.gather), device=sim.device, order=c.order,
                                grid_shape=c.local_grid.shape, capacity=c.capacity, dtype=sim.shard_state.pos.dtype,
                                requested=c.backend)

    # (a) the main cell on a 4x2 mesh: 8 shards of 32x64x128 on the card
    t0 = time.perf_counter()
    sx, sy = DIST_MESH
    nx_loc, ny_loc = MAIN["grid"][0] // sx, MAIN["grid"][1] // sy
    probe = scenario("uniform", **MAIN)
    # the migration buffer from the face flux: a face's cells, ppc particles
    # a cell, a step moving at most 4 (u_thermal + seed amplitude) dt of a cell
    flux = probe.plasma.ppc * max(nx_loc, ny_loc) * MAIN["grid"][2] * min(
        1.0, 4 * (probe.plasma.u_thermal + probe.plasma.perturb.amplitude) * probe.dt)
    mig_cap = 1 << math.ceil(math.log2(max(flux, 256)))
    kernels.reset_launch_counts()
    dispatch.counters["plain_on_card"] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sim = make_simulation(scenario("uniform", **MAIN, mesh=f"{sx}x{sy}", mig_cap=mig_cap,
                                   diagnostics_every=MAIN["window"]))
    if not isinstance(sim, DistSimulation):
        fail("make_simulation of a meshed spec did not build the distributed driver")
    chosen = dist_resolved(sim)
    n0 = sim.diagnostics()["n_alive"]
    setup_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    sim.run(MAIN["window"])  # the first window: the capture and its warm-up step
    torch.cuda.synchronize()
    say(f"dist main cell {MAIN['grid']}, mesh {sx}x{sy} (local {sim.config.local_grid.shape}), order {MAIN['order']}: "
        f"{n0} particles, n_local {sim.n_local}, mig_cap {mig_cap}, set-up {setup_s:.2f} s, first window "
        f"{time.perf_counter() - t1:.2f} s; growths before the timed window {sim.growths}; resolved {chosen}")
    reads0, windows0 = sim.host_reads, sim.windows
    t2 = time.perf_counter()
    sim.run(MAIN["steps"] - MAIN["window"])
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    steps = MAIN["steps"]
    timed = steps - MAIN["window"]
    ms_step = 1e3 * (t3 - t2) / timed
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts = fused(kernels.launch_counts())
    reads_w = (sim.host_reads - reads0) / max(sim.windows - windows0, 1)
    want = {KERNEL_OF[kv]: sx * sy * (steps + sim.graph_captures) for kv in chosen.items() if kv in KERNEL_OF}
    ddist = sim.diagnostics()
    say(f"  {ms_step:.2f} ms/step ({timed} steps after the first window), {n0 * timed / (t3 - t2):.4e} "
        f"particle-steps/s, peak {peak_gb:.2f} GB, captures {sim.graph_captures}, host reads {reads_w:.2f} a window, "
        f"growths {sim.growths}, sorts {sim.sorts}, rebuilds {sim.rebuilds}")
    say(f"  comm_stats {sim.comm_stats}: {sim.comm_stats['n_migrated'] / steps:.1f} migrated particles and "
        f"{sim.comm_stats['mig_payload_bytes'] / steps:.0f} payload bytes a step; launches {counts} "
        f"(want {want}: {sx * sy} a step, one a shard, and the capture's warm-up step)")
    if sim.graph_captures != 1 or reads_w != 1.0 or any(sim.growths.values()):
        fail(f"dist main cell: {sim.graph_captures} captures, {reads_w} reads a window, growths {sim.growths}")
    if len(chosen) != 2 or any(kv not in KERNEL_OF for kv in chosen.items()) or counts != want:
        fail(f"dist main cell did not launch the resolved kernels once a shard a step: {counts}, want {want}")
    no_plain(dispatch, "dist main cell")
    say(f"  {shard_kernels(torch, sim, chosen)}")
    say(f"  {exchange_times(torch, sim, torch.Generator(device=dev).manual_seed(19))}")
    dist_history = list(sim.history)
    dist_fields = sim.fields_global().all()
    del sim
    torch.cuda.empty_cache()
    single = make_simulation(scenario("uniform", **MAIN, diagnostics_every=MAIN["window"]))
    single.run()
    dsingle = single.diagnostics()
    repeat = main_final is None or same_state(torch, host_copy(single), main_final)
    drift = energy_drift(dsingle, ddist)
    rows = [abs(a["total_energy"] - b["total_energy"]) / abs(a["total_energy"])
            for a, b in zip(single.history, dist_history)]
    fdrift = field_drift(dist_fields, single.state.fields.all())
    fe_rel = abs(ddist["field_energy"] - dsingle["field_energy"]) / abs(dsingle["field_energy"])
    say(f"  against the single-device run (bit-equal to phase 4's: {repeat}): n_alive {ddist['n_alive']} / "
        f"{dsingle['n_alive']}, energies field {ddist['field_energy']:.7e} / {dsingle['field_energy']:.7e}, kinetic "
        f"{ddist['kinetic_energy']:.7e} / {dsingle['kinetic_energy']:.7e}, largest drift {drift:.2e} of the total, "
        f"history rows {[f'{r:.2e}' for r in rows]} (tolerance 1e-4); field energy {fe_rel:.2e} of itself, fields "
        f"max |diff| / max |field| {fdrift:.2e} (tolerance 1e-4 each)")
    if (not repeat or ddist["n_alive"] != dsingle["n_alive"] or drift > 1e-4 or len(rows) != len(single.history)
            or not rows or max(rows) > 1e-4 or fe_rel > 1e-4 or fdrift > 1e-4):
        fail("dist main cell disagrees with the single-device run")
    del single, dist_fields
    torch.cuda.empty_cache()
    say(f"phase 19a: {time.perf_counter() - t0:.1f} s")

    # (b) lwfa at its registry size on 2x2
    t0 = time.perf_counter()
    runs = {}
    for mesh in (None, "2x2"):
        kernels.reset_launch_counts()
        s = make_simulation(scenario("lwfa", steps=20, diagnostics_every=10, mesh=mesh))
        s.run()
        runs[mesh] = (s.diagnostics(), list(s.history), fused(kernels.launch_counts()), s)
    (d1, h1, _, s1), (d2, h2, c2, s2) = runs[None], runs["2x2"]
    drift = max([energy_drift(d1, d2)] + [abs(a["total_energy"] - b["total_energy"]) / abs(a["total_energy"])
                                           for a, b in zip(h1, h2)])
    fdrift = field_drift(s2.fields_global().all(), s1.state.fields.all())
    fe_rel = abs(d1["field_energy"] - d2["field_energy"]) / abs(d1["field_energy"])
    say(f"dist lwfa {s2.global_grid.shape} on 2x2: n_alive {d2['n_alive']} / {d1['n_alive']}, largest energy drift "
        f"{drift:.2e} of the total, field energy {fe_rel:.2e} of itself, fields max |diff| / max |field| "
        f"{fdrift:.2e} (tolerance 1e-3 each), growths {s2.growths}, comm_stats {s2.comm_stats}, launches {c2}; "
        f"{time.perf_counter() - t0:.1f} s")
    if d1["n_alive"] != d2["n_alive"] or max(drift, fe_rel, fdrift) > 1e-3 or len(h1) != len(h2) or not c2:
        fail("dist lwfa disagrees with the single-device run")
    say(f"  {shard_kernels(torch, s2, dist_resolved(s2))}")
    del runs, s1, s2
    no_plain(dispatch, "dist lwfa")

    # (c) overlapped halos bit-equal to the serialized exchange; (d)
    # compressed migration: charge exact, nothing lost, 16 of 28 bytes a row
    t0 = time.perf_counter()
    small = dict(grid=(32, 32, 32), ppc=2, order=3, steps=16, window=8, diagnostics_every=4, mesh="4x2")
    variants = {}
    for label, kw in (("serialized", {}), ("overlapped", dict(overlap_halo=True)),
                      ("compressed", dict(compress_migration=True))):
        s = make_simulation(scenario("uniform", u_thermal=0.1, **small, **kw))
        s.run()
        variants[label] = s
    base, over, comp = variants["serialized"], variants["overlapped"], variants["compressed"]
    bit = dist_state_equal(torch, base, over) and all(
        torch.equal(base.state[k], over.state[k]) for k in ("slots", "pslot", "slab_d"))
    charge = lambda s: float(torch.sum(s.state["w"].double() * s.state["alive"]))
    ratio = comp.comm_stats["mig_payload_bytes"] / base.comm_stats["mig_payload_bytes"]
    dc, db = comp.diagnostics(), base.diagnostics()
    say(f"dist 32^3 order 3 on 4x2: overlapped halos bit-equal to serialized: {bit}; compressed migration: charge "
        f"{charge(comp):.9e} / {charge(base):.9e}, n_alive {dc['n_alive']} / {db['n_alive']}, migrated "
        f"{comp.comm_stats['n_migrated']}, payload {ratio * 28:.1f} of 28 bytes a row, energy drift "
        f"{energy_drift(db, dc):.2e}; {time.perf_counter() - t0:.1f} s")
    if not bit:
        fail("the overlapped exchange is not bit-equal to the serialized one")
    say(f"  {shard_kernels(torch, base, dist_resolved(base))}")
    if (charge(comp) != charge(base) or dc["n_alive"] != db["n_alive"] or abs(ratio - 16 / 28) > 1e-12
            or not comp.comm_stats["n_migrated"]):
        fail("compressed migration lost charge or particles, or did not compress")
    del variants, base, over, comp
    no_plain(dispatch, "dist comm options")

    # (e) both growth hatches, then the forced-imbalance rebalance
    t0 = time.perf_counter()
    hot = dict(grid=(32, 32, 32), ppc=2, order=1, capacity=8, u_thermal=0.4, steps=20, window=10,
               diagnostics_every=10)
    grown = make_simulation(scenario("uniform", **hot, mesh="4x2", mig_cap=1))
    grown.run()
    ref1 = make_simulation(scenario("uniform", **hot))
    ref1.run()
    dg, dr = grown.diagnostics(), ref1.diagnostics()
    say(f"dist growth, hot 32^3 on 4x2 from mig_cap 1 and capacity 8: growths {grown.growths}, halts {grown.halts}, "
        f"captures {grown.graph_captures}, n_alive {dg['n_alive']} / {dr['n_alive']}, energy drift "
        f"{energy_drift(dr, dg):.2e} (tolerance 2e-2)")
    if (not grown.growths["mig_cap"] or not grown.growths["capacity"] or dg["n_alive"] != dr["n_alive"]
            or energy_drift(dr, dg) > 2e-2):
        fail("the growth hatches did not fire, or the grown run lost particles or drifted")
    del grown, ref1
    imb = dict(grid=(16, 8, 16), ppc=2, order=1, capacity=48, u_thermal=0.05, steps=20, window=10, mesh="4x2",
               mig_cap=512, diagnostics_every=10)
    parts = build_particles(scenario("uniform", **imb), device=dev)
    # the plasma of the first x-shard only: 6 of 8 shards empty
    parts = dataclasses.replace(parts, alive=parts.alive & (parts.pos[:, 0] < imb["grid"][0] // 4))
    n_start, q_start = int(parts.alive.sum()), float(torch.sum(parts.w.double() * parts.alive))
    pieces = {}
    for label, kw in (("fixed", {}), ("rebalanced", dict(rebalance_enable=True, imbalance_ratio=2.0))):
        s = make_simulation(scenario("uniform", **imb, **kw), particles=parts)
        s.run()
        pieces[label] = s
    fixed, reb = pieces["fixed"], pieces["rebalanced"]
    dfx, drb = fixed.diagnostics(), reb.diagnostics()
    q = float(torch.sum(reb.state["w"].double() * reb.state["alive"]))
    say(f"dist rebalance, (16, 8, 16) with every particle in the first x-shard of 4x2: re-splits "
        f"{reb.growths['rebalance']} to {reb.mesh_shape}, max imbalance {reb.comm_stats['max_imbalance']:.2f}, "
        f"n_alive {drb['n_alive']} / {n_start}, charge {q:.9e} / {q_start:.9e}, energy drift against the fixed "
        f"split {energy_drift(dfx, drb):.2e} (tolerance 1e-3); {time.perf_counter() - t0:.1f} s")
    if (not reb.growths["rebalance"] or reb.mesh_shape == (4, 2) or drb["n_alive"] != n_start or q != q_start
            or energy_drift(dfx, drb) > 1e-3):
        fail("the rebalance did not re-split, lost particles or charge, or drifted")
    del pieces, fixed, reb
    no_plain(dispatch, "dist growths and rebalance")

    # (f) chaos and checkpoints at 32^3, order 3, 4x2
    t0 = time.perf_counter()
    chaos = dict(grid=(32, 32, 32), ppc=2, order=3, steps=24, window=8, diagnostics_every=4, mesh="4x2")
    clean = make_simulation(scenario("uniform", **chaos))
    n0 = clean.n_local
    clean.run()
    results = {}
    auto = ROOT / "build" / "chip_smoke_dist_autosave"
    ckpt = ROOT / "build" / "chip_smoke_dist_checkpoint"
    try:
        for label, kw in (("sentinel", {}), ("nan_field", dict(fault={"kind": "nan_field", "step": 11,
                                                                       "component": "ez"})),
                          ("recv_drop", dict(fault={"kind": "recv_drop", "step": 9})),
                          ("crash", dict(fault={"kind": "crash", "step": 13}))):
            s = make_simulation(scenario("uniform", **chaos, health={"enable": True}, **kw))
            if label == "crash":
                shutil.rmtree(auto, ignore_errors=True)
                s.run(autosave_every=8, autosave_path=str(auto))
            else:
                s.run()
            results[label] = (dist_state_equal(torch, clean, s, n0), dict(s.halts), s.retries, s.restarts,
                              s.discarded_steps, dict(s.growths), s.n_local)
            del s
        first = make_simulation(scenario("uniform", **chaos))
        first.run(10)
        first.save(str(ckpt))
        resumed = load_simulation(str(ckpt))
        resumed.run(14)
        results["checkpoint"] = (dist_state_equal(torch, clean, resumed) and resumed.sorts == clean.sorts,
                                 {}, 0, 0, 0, dict(resumed.growths), resumed.n_local)
        del first, resumed
    finally:
        shutil.rmtree(auto, ignore_errors=True)
        shutil.rmtree(ckpt, ignore_errors=True)
    for label, (ok, halts, retries, restarts, discarded, growths, n_local) in results.items():
        say(f"dist chaos {label}: bit-equal to the clean run {ok}, halts {halts}, retries {retries}, restarts "
            f"{restarts}, discarded steps {discarded}, growths {growths}, n_local {n_local}")
    want = {"sentinel": ({}, 0, 0, 0), "nan_field": ({"nonfinite": 1}, 1, 0, 0),
            "recv_drop": ({"mig_recv_dropped": 1}, 0, 0, 1), "crash": ({}, 0, 1, 0), "checkpoint": ({}, 0, 0, 0)}
    for label, (halts, retries, restarts, discarded) in want.items():
        ok, got_halts, got_retries, got_restarts, got_discarded, growths, n_local = results[label]
        if not ok or (got_halts, got_retries, got_restarts, got_discarded) != (halts, retries, restarts, discarded):
            fail(f"dist chaos {label}: not bit-equal to the clean run, or counters {results[label]}")
    if results["recv_drop"][5]["n_local"] != 1 or results["recv_drop"][6] != 2 * n0:
        fail(f"dist chaos recv_drop: n_local did not double once: {results['recv_drop']}")
    del clean
    torch.cuda.empty_cache()
    no_plain(dispatch, "dist chaos and checkpoints")
    say(f"phase 19f: {time.perf_counter() - t0:.1f} s")


def lm_phase(torch, dev, smi: str) -> None:
    """Phase 20: the language-model stack on the card (see the module
    docstring). ``smi``: the card's name and power limit, printed beside
    every number."""
    import dataclasses

    from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
    from repro_torch.launch.serve import generate, make_inputs
    from repro_torch.models import decode_step, encode, forward, init_decode_state, init_params
    from repro_torch.models import moe as lm_moe
    from repro_torch.models.common import tree_map

    torch.set_float32_matmul_precision("highest")
    # every MoE dispatch of a run, recorded as (expert ids, slot_token, a_slot, fits)
    dispatches = []
    dispatch_row = lm_moe._dispatch_row

    def recording(expert_ids, **kw):
        out = dispatch_row(expert_ids, **kw)
        dispatches.append(tuple(t.cpu() for t in (expert_ids,) + out))
        return out

    def run(params, cfg, toks, extra, device, n_prefill: int):
        """Forward over ``toks``, then a block prefill of its first
        ``n_prefill`` tokens and one-token steps over the rest: the logits of
        each, on the host, and the MoE dispatches they made."""
        dispatches.clear()
        toks = toks.to(device)
        extra = {k: v.to(device) for k, v in extra.items()}
        with torch.no_grad():
            out = [forward(params, toks, cfg, remat=False, **extra)]
            enc = encode(params, extra["frames"], cfg) if "frames" in extra else None
            st = init_decode_state(cfg, toks.shape[0], toks.shape[1], cfg.dtype, device=device)
            lg, st = decode_step(params, st, toks[:, :n_prefill], cfg, enc_out=enc)
            out.append(lg)
            for t in range(n_prefill, toks.shape[1]):
                lg, st = decode_step(params, st, toks[:, t:t + 1], cfg, enc_out=enc)
                out.append(lg)
        return [o.cpu() for o in out], list(dispatches)

    def card_vs_cpu(cfg, n_tokens: int, n_prefill: int, tol: float, seed: int):
        gen = torch.Generator().manual_seed(seed)
        params = init_params(gen, cfg, device="cpu")
        toks = torch.randint(0, cfg.vocab_size, (2, n_tokens), generator=gen)
        extra = {}
        if cfg.encoder_layers:
            extra["frames"] = torch.randn((2, cfg.encoder_frames, cfg.d_model), generator=gen)
        if cfg.prefix_tokens:
            extra["prefix_embeddings"] = torch.randn((2, cfg.prefix_tokens, cfg.d_model), generator=gen)
        want, want_d = run(params, cfg, toks, extra, torch.device("cpu"), n_prefill)
        got, got_d = run(tree_map(lambda t: t.to(dev), params), cfg, toks, extra, dev, n_prefill)
        del params
        errs = []
        for i, (g, w) in enumerate(zip(got, want)):
            if not bool(torch.isfinite(g).all()):
                fail(f"{cfg.name}: logits not finite on the card (pass {i})")
            scale = float(w.abs().max())
            err = float((g - w).abs().max()) / scale
            if err > tol:
                fail(f"{cfg.name}: card against CPU {err:.3e} of max|cpu| (tolerance {tol}) in pass {i}")
            errs.append(err)
        if len(got_d) != len(want_d):
            fail(f"{cfg.name}: {len(got_d)} MoE dispatches on the card, {len(want_d)} on the CPU")
        n_diff = sum(int((g[0] != w[0]).sum()) for g, w in zip(got_d, want_d))
        n_all = sum(w[0].numel() for w in want_d)
        return max(errs), got_d, want_d, n_diff, n_all

    lm_moe._dispatch_row = recording
    try:
        # (a) every arch's smoke config, float32: forward, a block prefill of
        # 8 and 8 one-token steps, card against CPU; the dispatch exact
        t0 = time.perf_counter()
        for i, arch in enumerate(ARCH_IDS):
            cfg = get_smoke_config(arch)
            err, got_d, want_d, _, _ = card_vs_cpu(cfg, 16, 8, 1e-4, LM_SMOKE_SEED + i)
            for g, w in zip(got_d, want_d):
                if not all(torch.equal(a, b) for a, b in zip(g, w)):
                    fail(f"{arch} smoke: the MoE dispatch on the card differs from the CPU's")
            moe = f"; {len(got_d)} MoE dispatches exact" if got_d else ""
            say(f"  {arch} smoke: card against CPU {err:.2e} of max|cpu| (tolerance 1e-4) over forward, prefill "
                f"and 8 steps{moe} [{smi}]")
        say(f"phase 20a: {time.perf_counter() - t0:.1f} s")

        # (b) two published widths cut to one period, float32, batch 2, 16
        # tokens (forward and a block prefill) then 4 one-token steps
        t0 = time.perf_counter()
        for arch in LM_ONE_PERIOD:
            full = get_config(arch, dtype=torch.float32)
            cfg = dataclasses.replace(full, n_layers=len(full.pattern))
            err, _, _, n_diff, n_all = card_vs_cpu(cfg, 20, 16, 1e-3, 100)
            share = f"{n_diff} of {n_all} MoE assignments differ" if n_all else "no MoE layer"
            say(f"  {arch}, one period at full width (d {cfg.d_model}, vocab {cfg.vocab_size}, "
                f"{cfg.param_count() / 1e9:.2f} B params): card against CPU {err:.2e} of max|cpu| (tolerance 1e-3); "
                f"{share} [{smi}]")
        say(f"phase 20b: {time.perf_counter() - t0:.1f} s")
    finally:
        lm_moe._dispatch_row = dispatch_row
    torch.cuda.empty_cache()

    # (c) the full configs in bfloat16, served through generate twice
    for arch in LM_ONE_PERIOD:
        t0 = time.perf_counter()
        cfg = get_config(arch)
        torch.cuda.reset_peak_memory_stats()
        params, prompt, enc_out = make_inputs(cfg, LM_FULL["batch"], LM_FULL["prompt"], seed=0, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        runs = [generate(params, cfg, prompt, LM_FULL["tokens"], enc_out=enc_out) for _ in range(2)]
        peak = torch.cuda.max_memory_allocated() / 1e9
        if not all(g.finite for g in runs):
            fail(f"{arch}: a logit is not finite")
        if not torch.equal(runs[0].tokens, runs[1].tokens):
            fail(f"{arch}: two runs gave different greedy tokens")
        b, n = LM_FULL["batch"], LM_FULL["tokens"]
        for j, g in enumerate(runs):
            say(f"  {arch} (bf16, {cfg.n_layers} layers, {cfg.param_count() / 1e9:.2f} B params), batch {b}, prompt "
                f"{LM_FULL['prompt']}, {n} tokens, run {j + 1}: prefill {g.prefill_ms:.2f} ms, decode "
                f"{g.decode_ms:.2f} ms/step, {b * 1e3 / g.decode_ms:.1f} tokens/s; peak {peak:.2f} GB [{smi}]")
        line = f"  {arch}: every logit finite, both runs' greedy tokens identical"
        if cfg.moe is None:
            # nothing is dropped: the last step's logits against the forward
            # over the same tokens
            seq = torch.cat([prompt, runs[1].tokens[:, :-1].to(dev)], dim=1)
            with torch.no_grad():
                ref = forward(params, seq, cfg, remat=False)[:, -1].float()
            err = float((runs[1].logits.float() - ref).abs().max()) / float(ref.abs().max())
            if err > 5e-2:
                fail(f"{arch}: decode logits {err:.3e} of max|logit| off the forward (tolerance 5e-2)")
            line += f"; decode against forward at the last position {err:.2e} of max|logit| (tolerance 5e-2)"
        say(line + f"; parameters made in {init_s:.2f} s, {time.perf_counter() - t0:.1f} s in all")
        del params, prompt, enc_out, runs
        torch.cuda.empty_cache()


class _NoCheckpoint:
    """A checkpoint manager that writes nothing: phase 21(d) runs the full
    width through the `Supervisor` without a 38 GB save (saves and restores
    are held bit for bit at (b)'s sizes). It counts the saves asked for."""

    def __init__(self):
        self.saves = 0

    def save(self, step, tree, *, blocking=True):
        self.saves += 1

    def wait(self):
        pass

    def latest_step(self):
        return None


def train_phase(torch, np, dispatch, dev, smi: str) -> None:
    """Phase 21: LM training on the card (see the module docstring)."""
    import dataclasses
    import statistics

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
    from repro_torch.data import DataConfig, global_batch_at
    from repro_torch.distributed.fault import FailureInjector, Supervisor
    from repro_torch.launch.flops import forward_flops
    from repro_torch.launch.train import StepClock
    from repro_torch.models import LayerSpec, ModelConfig, MoEConfig, params_from_numpy, params_to_numpy
    from repro_torch.models import common as lm_common
    from repro_torch.models import moe as lm_moe
    from repro_torch.optim import AdamWConfig, ScheduleConfig
    from repro_torch.train import TrainConfig, init_train_state, make_train_step

    torch.set_float32_matmul_precision("highest")
    leaves = lm_common.tree_leaves
    no_plain(dispatch, "before LM training")

    def bit_equal(a, b) -> bool:
        return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))

    # (a) every arch's smoke config, 3 float32 steps, card against CPU
    t0 = time.perf_counter()
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3), schedule=ScheduleConfig(warmup_steps=2, total_steps=10))
    for i, arch in enumerate(ARCH_IDS):
        cfg = get_smoke_config(arch)
        cpu = init_train_state(torch.Generator().manual_seed(LM_SMOKE_SEED + i), cfg, device="cpu")
        card = params_from_numpy(params_to_numpy(cpu), dev)
        step = make_train_step(cfg, tcfg)
        data = DataConfig(vocab_size=cfg.vocab_size, global_batch=2, seq_len=16, seed=i)
        worst, lrs = 0.0, []
        for s in range(LM_TRAIN_SMOKE_STEPS):
            batch = global_batch_at(s, data, device="cpu")
            gen = torch.Generator().manual_seed(1000 + s)
            if cfg.encoder_layers:
                batch["frames"] = torch.randn((2, cfg.encoder_frames, cfg.d_model), generator=gen)
            if cfg.prefix_tokens:
                batch["prefix_embeddings"] = torch.randn((2, cfg.prefix_tokens, cfg.d_model), generator=gen)
            cpu, m_cpu = step(cpu, batch)
            card, m_card = step(card, {k: v.to(dev) for k, v in batch.items()})
            lrs.append(tcfg.optimizer.lr * float(m_cpu["lr_scale"]))
            for k in ("loss", "grad_norm", "moe_load_balance"):
                if k not in m_cpu:
                    continue
                want, got = float(m_cpu[k]), float(m_card[k])
                if not math.isfinite(got):
                    fail(f"{arch} smoke train step {s}: {k} is not finite on the card")
                err = abs(got - want) / max(abs(want), 1e-6)
                if err > 1e-4:
                    fail(f"{arch} smoke train step {s}: {k} {got!r} on the card, {want!r} on the CPU "
                         f"(tolerance 1e-4 relative)")
                worst = max(worst, err)
        # an early Adam step moves a parameter by about lr * sign(g): a
        # gradient near 0 can flip sign between the card and the CPU
        p_err, stray, bound_abs = 0.0, 0.0, 2 * sum(lrs)
        for a, b in zip(leaves(card["params"]), leaves(cpu["params"])):
            diff = (a.cpu().double() - b.double()).abs()
            scale = float(b.abs().max())
            if float(diff.max()) > bound_abs * (1 + 1e-4):
                fail(f"{arch} smoke: a parameter {float(diff.max()):.3e} off the CPU's after "
                     f"{LM_TRAIN_SMOKE_STEPS} steps (tolerance 2 x the sum of the lr, {bound_abs:.1e})")
            p_err = max(p_err, float(diff.max()) / max(scale, 1e-30))
            stray = max(stray, float((diff > 1e-4 * scale).double().mean()))
        if stray > 5e-3:
            fail(f"{arch} smoke: {stray:.2%} of a leaf's parameters beyond 1e-4 of its largest off the CPU's")
        say(f"  {arch} smoke, {LM_TRAIN_SMOKE_STEPS} train steps: loss, grad norm and MoE balance within "
            f"{worst:.2e} of the CPU's (tolerance 1e-4); parameters within {p_err:.2e} of each leaf's largest, "
            f"{stray:.2%} of a leaf beyond 1e-4 (tolerance 0.5%) [{smi}]")
        del cpu, card
    say(f"phase 21a: {time.perf_counter() - t0:.1f} s")

    # (b) determinism on the card: tests/test_training.py's configs
    t0 = time.perf_counter()
    tiny = ModelConfig(name="tiny", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=64,
                       pattern=(LayerSpec("attn"),))
    tiny_moe = dataclasses.replace(tiny, name="tiny_moe", pattern=(LayerSpec("attn", "moe"),),
                                   moe=MoEConfig(n_experts=4, top_k=2, capacity_factor=2.0))
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=3e-3), schedule=ScheduleConfig(warmup_steps=5, total_steps=100))
    data = DataConfig(vocab_size=64, global_batch=8, seq_len=32, seed=0)
    ckpt_root = ROOT / "build" / "chip_smoke_train_ckpt"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    try:
        for cfg, ratio in ((tiny, 0.8), (tiny_moe, 0.9)):
            train_step = make_train_step(cfg, tcfg)

            def step_fn(st, i):
                return train_step(st, global_batch_at(i, data, device=dev))

            def fresh():
                return init_train_state(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)

            runs = []
            for _ in range(2):
                st = fresh()
                for i in range(10):
                    st, _ = step_fn(st, i)
                runs.append(st)
            if not bit_equal(runs[0], runs[1]):
                fail(f"{cfg.name}: two straight 10-step runs on the card differ")
            # a failure before step 6 finds the held state equal to the save
            # of step 6 (the reference's test); one before step 7 finds it a
            # step ahead, so the restore must roll it back and step 6 replays
            for fail_at in (6, 7):
                mgr = CheckpointManager(str(ckpt_root / cfg.name / f"crash{fail_at}"), keep=5)
                sup = Supervisor(step_fn, mgr, save_every=2, injector=FailureInjector((fail_at,)), async_save=True)
                crashed, last = sup.run(fresh(), 10)
                replayed = [m["step"] for m in sup.metrics_log]
                if (last != 10 or sup.restarts != 1 or replayed != [*range(fail_at), *range(6, 10)]
                        or not bit_equal(crashed, runs[0])):
                    fail(f"{cfg.name}: the run restored from the async save of step 6 after a failure at step "
                         f"{fail_at} (saves every 2) is not bit-equal to the straight run (restarts "
                         f"{sup.restarts}, steps run {replayed})")
            sup = Supervisor(step_fn, CheckpointManager(str(ckpt_root / cfg.name / "long"), keep=2),
                             async_save=True)
            sup.run(fresh(), 30)
            losses = [float(m["loss"]) for m in sup.metrics_log]
            if not (all(math.isfinite(x) for x in losses) and losses[-1] < ratio * losses[0]):
                fail(f"{cfg.name}: 30 supervised steps took the loss from {losses[0]:.4f} to {losses[-1]:.4f}, "
                     f"not below {ratio} of the first")
            say(f"  {cfg.name}: two straight 10-step runs bit-equal; failures at steps 6 and 7 restored from the "
                f"async save of step 6 (at 7 rolled back a step and replayed), bit-equal to them; 30 supervised "
                f"steps: loss {losses[0]:.4f} -> "
                f"{losses[-1]:.4f} (below {ratio} of the first)")
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    say(f"phase 21b: {time.perf_counter() - t0:.1f} s")

    # (c) the two repaired backwards at full-width shapes, each 3 times
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(21)
    rng = np.random.default_rng(21)
    zipf = 1.0 / np.arange(1, EMBED["vocab"] + 1)
    ids = torch.from_numpy(rng.choice(EMBED["vocab"], size=EMBED["tokens"], p=zipf / zipf.sum())).to(dev)
    table = torch.randn((EMBED["vocab"], EMBED["d"]), generator=gen, device=dev).to(torch.bfloat16)
    table.requires_grad_(True)
    g_rows = torch.randn((EMBED["tokens"], EMBED["d"]), generator=gen, device=dev).to(torch.bfloat16)

    def embed_new():
        return torch.autograd.grad(lm_common.embed_lookup(table, ids), table, g_rows)[0]

    def embed_atomic():
        # the float32 sums, before the cast to the table's dtype (which
        # would hide most of the order's effect)
        order = torch.argsort(ids, stable=True)
        dt = torch.zeros((EMBED["vocab"], EMBED["d"]), dtype=torch.float32, device=dev)
        dt.index_add_(0, ids[order], g_rows[order].float())
        return dt

    moe_cfg = get_config("deepseek-moe-16b").moe
    b, s, d, k = 2, 4096, get_config("deepseek-moe-16b").d_model, moe_cfg.top_k
    cap = lm_moe._capacity(s, moe_cfg)
    logits = torch.randn((b, s, moe_cfg.n_experts), generator=gen, device=dev)
    expert_ids = torch.topk(logits, k, dim=-1).indices
    slot_token, a_slot, fits = lm_moe._dispatch_row(expert_ids, n_experts=moe_cfg.n_experts, cap=cap, s=s, k=k)
    x = torch.randn((b, s, d), generator=gen, device=dev).to(torch.bfloat16).requires_grad_(True)
    cot = torch.randn((b, moe_cfg.n_experts * cap, d), generator=gen, device=dev).to(torch.bfloat16)

    def dispatch_new():
        return torch.autograd.grad(lm_moe._DispatchGather.apply(x, slot_token, a_slot, k), x, cot)[0]

    def dispatch_atomic():
        x_ext = torch.cat([x, x.new_zeros((b, 1, d))], dim=1)
        out = torch.gather(x_ext, 1, slot_token.long()[..., None].expand(b, slot_token.shape[1], d))
        return torch.autograd.grad(out, x, cot)[0]

    for name, new, atomic, shape in (
            ("embedding backward", embed_new, embed_atomic,
             f"{EMBED['tokens']} Zipf ids into phi3's {EMBED['vocab']} x {EMBED['d']} table, bf16"),
            ("MoE dispatch gather backward", dispatch_new, dispatch_atomic,
             f"deepseek-moe-16b's train shape: {b} x {s} tokens, top-{k} of {moe_cfg.n_experts} experts, capacity "
             f"{cap}, d {d}, bf16, {int((~fits).sum())} dropped assignments")):
        outs = [new() for _ in range(3)]
        if not all(torch.equal(outs[0], o) for o in outs[1:]):
            fail(f"{name}: three runs on the card are not bit-equal")
        ref = [atomic() for _ in range(3)]
        n_diff = max(int((ref[0] != r).sum()) for r in ref[1:])
        want = ref[0].to(outs[0].dtype).float()
        err = float((outs[0].float() - want).abs().max()) / float(want.abs().max())
        ms_new, ms_atomic = time_ms(torch, new, 5), time_ms(torch, atomic, 5)
        say(f"  {name} ({shape}): 3 runs bit-equal; {ms_new:.3f} ms against the atomic route's {ms_atomic:.3f} "
            f"ms, whose 3 runs differ in {n_diff} elements; new against atomic {err:.2e} of the largest (bf16 rounding) "
            f"[{smi}]")
        del outs, ref
    del table, g_rows, x, cot
    torch.cuda.empty_cache()
    say(f"phase 21c: {time.perf_counter() - t0:.1f} s")

    # (d) phi3-mini-3.8b at full width: bf16 params, float32 moments,
    # train_4k's sequence at batch 2, remat on, through the Supervisor
    t0 = time.perf_counter()
    cfg = get_config(LM_TRAIN_FULL["arch"])
    bsz, seq, n = LM_TRAIN_FULL["batch"], LM_TRAIN_FULL["seq"], LM_TRAIN_FULL["steps"]
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3), schedule=ScheduleConfig(warmup_steps=10, total_steps=n))
    data = DataConfig(vocab_size=cfg.vocab_size, global_batch=bsz, seq_len=seq, seed=0)
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    torch.cuda.synchronize()
    state_gb = torch.cuda.memory_allocated() / 1e9
    clock = StepClock(dev)
    train_step = clock.wrap(make_train_step(cfg, tcfg))
    saver = _NoCheckpoint()
    sup = Supervisor(lambda st, i: train_step(st, global_batch_at(i, data, device=dev)), saver, async_save=True)
    state, _ = sup.run(state, n)
    step_ms = clock.ms()
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(m["loss"]) for m in sup.metrics_log]
    if len(losses) != n or not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"{cfg.name} at full width: losses {losses} (every one finite and the last below the first)")
    ms = statistics.median(step_ms[1:])
    fwd = forward_flops(cfg, n_tokens=bsz * seq, s_ctx=seq / 2, enc_tokens=0)
    tflops = 4.0 * fwd / (ms * 1e-3) / 1e12
    say(f"  {cfg.name} (bf16, {cfg.n_layers} layers, {cfg.param_count() / 1e9:.2f} B params, float32 moments; "
        f"state {state_gb:.2f} GB), batch {bsz} x {seq}, remat, {n} steps through the Supervisor: {ms:.1f} ms/step "
        f"(median of steps 2-{n}; first {step_ms[0]:.1f}), {bsz * seq * 1e3 / ms:.1f} tokens/s, peak {peak:.2f} GB, "
        f"{tflops:.1f} model TFLOP/s (4 x forward_flops {fwd / 1e12:.2f} TFLOP), {tflops * 1e12 / PEAK_BF16_FLOPS:.1%} "
        f"of the dense bf16 peak {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s; saves asked {saver.saves} (not written) [{smi}]")
    say("  losses " + " ".join(f"{x:.4f}" for x in losses))
    # one step with two microbatches from the same state
    torch.cuda.reset_peak_memory_stats()
    clock2 = StepClock(dev)
    mb_step = clock2.wrap(make_train_step(cfg, dataclasses.replace(tcfg, microbatches=2)))
    state, m = mb_step(state, global_batch_at(n, data, device=dev))
    mb_ms = clock2.ms()[0]
    mb_peak = torch.cuda.max_memory_allocated() / 1e9
    if not math.isfinite(float(m["loss"])):
        fail(f"{cfg.name}: the microbatches=2 step's loss is not finite")
    say(f"  microbatches=2, one step from that state: {mb_ms:.1f} ms, peak {mb_peak:.2f} GB, loss "
        f"{float(m['loss']):.4f} [{smi}]")
    del state, sup, m
    torch.cuda.empty_cache()
    say(f"phase 21d: {time.perf_counter() - t0:.1f} s")
    no_plain(dispatch, "LM training")


def main() -> None:
    import numpy as np
    import torch

    # -- 1. device -----------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device: the port's main path runs on the GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    say(smi)
    card = torch.cuda.get_device_name(0)
    say(f"device: {card}, torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.device_count()} visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    # every run times the dispatcher's candidates from nothing
    AUTOTUNE_CACHE.parent.mkdir(parents=True, exist_ok=True)
    AUTOTUNE_CACHE.unlink(missing_ok=True)
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(AUTOTUNE_CACHE)

    from repro_torch import kernels
    from repro_torch.api import (
        SimulationHealthError,
        SortPolicyConfig,
        load_simulation,
        make_simulation,
        scenario,
        two_stream_growth_rate,
        weibel_growth_rate,
    )
    from repro_torch.core import (
        CURRENT_STAGGER,
        EB_STAGGERS,
        NO_STAGGER,
        bin_items,
        bin_slab_staging,
        binned_shape_factors,
        build_bins,
        cell_coords,
        cell_index,
        extract_neighborhoods,
        matrix_scatter_add,
        max_guard,
        shape_weights,
        slot_gather,
        support,
        unified_support,
    )
    from repro_torch.kernels import build, dispatch
    from repro_torch.kernels.deposition import ops as dep
    from repro_torch.kernels.deposition import ref as dep_ref
    from repro_torch.kernels.gather import ops as gat
    from repro_torch.kernels.gather import ref as gat_ref
    from repro_torch.kernels.scatter_matrix import ops as seg
    from repro_torch.kernels.scatter_matrix import ref as seg_ref
    from repro_torch.pic import lorentz_gamma

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    build.load_library()
    say(f"build: {time.perf_counter() - t0:.2f} s (nvcc {build.BUILD_INFO['seconds']:.2f} s, "
        f"cached={build.BUILD_INFO['cached']})")
    for line in build.BUILD_INFO["log"].splitlines():
        if "registers" in line or "spill" in line:
            say(f"  ptxas: {line.strip()}")
    report = ptxas_report(build.BUILD_INFO["log"])
    for name, n_inst in NO_SPILLS.items():
        found = {f: r for f, r in report.items() if name in f}
        if len(found) != n_inst or any(spill for _, spill in found.values()):
            fail(f"{name}: expected {n_inst} instances with 0 spill bytes, ptxas reports {found}")
        say(f"  {name}, {n_inst} instances: registers {[r for r, _ in found.values()]}, spill bytes "
            f"{[s_ for _, s_ in found.values()]}")

    # -- 3a. kernels vs plain versions at orders 1-3, small grid --------------
    gen = torch.Generator(device=dev).manual_seed(0)
    # the last case is a 256-cell column (the first reduced kernel's shared
    # accumulator needed more than the default 48 KB there)
    for order, grid, n in ((1, (6, 5, 7), 1500), (2, (6, 5, 7), 1500), (3, (6, 5, 7), 1500), (3, (2, 2, 256), 6000)):
        g = max_guard(order)
        pos = torch.rand((n, 3), generator=gen, device=dev) * torch.tensor(grid, dtype=torch.float32, device=dev)
        vel = torch.randn((n, 3), generator=gen, device=dev)
        qw = torch.rand((n,), generator=gen, device=dev) + 0.5
        layout, of = build_bins(cell_index(pos, grid), torch.ones(n, dtype=torch.bool, device=dev),
                                n_cells=math.prod(grid), capacity=64)
        if int(of):
            fail("small-grid binning overflowed")
        slab, val = bin_slab_staging(pos, vel, qw, layout, grid_shape=grid)
        d = slab.d
        padded = torch.randn((6, *(k + 2 * g for k in grid)), generator=gen, device=dev)
        errs = (
            exact(torch, dep.fused_bin_deposit(d, val, order=order),
                  dep_ref.fused_bin_deposit_ref(d.cpu(), val.cpu(), order=order)),
            max_err(torch, dep.fused_bin_deposit_reduced(d, val, order=order, grid_shape=grid, guard=g),
                    dep_ref.fused_bin_deposit_reduced_ref(d, val, order=order, grid_shape=grid, guard=g)),
            max_err(torch, gat.fused_bin_gather(d, padded, grid_shape=grid, order=order, guard=g),
                    gat_ref.fused_gather_ref(d, padded, grid_shape=grid, order=order, guard=g)),
        )
        say(f"order {order}, grid {grid}: max |kernel - plain| packed {errs[0]:.2e} (bit for bit, plain on the CPU), "
            f"reduced {errs[1]:.2e}, gather {errs[2]:.2e} (tolerance {ATOL} + {RTOL}*|plain|)")

    # the redesigned kernels at their edges: capacity 48 (a full and a
    # partial 32-slot chunk) with an all-gap cell and a full cell, on a grid
    # and on one-cell columns; a 1000-cell column; the packed kernel bit
    # equal to its plain version, the reduced kernel bit equal to the packed
    # kernel followed by the plain z pass, and every launch of the three
    # bit equal to the one before
    edge = [(order, grid, 48) for order in (1, 2, 3) for grid in ((5, 4, 6), (4, 3, 1))] + [(3, (1, 1, 1000), 8)]
    for order, grid, cap_e in edge:
        g = max_guard(order)
        d, val = synthetic_slab(torch, grid, cap_e, gen, dev, empty=(0,), full=(1,))
        padded = torch.randn((6, *(k + 2 * g for k in grid)), generator=gen, device=dev)
        reduced = dep.fused_bin_deposit_reduced(d, val, order=order, grid_shape=grid, guard=g)
        gathered = gat.fused_bin_gather(d, padded, grid_shape=grid, order=order, guard=g)
        errs = (max_err(torch, reduced, dep_ref.fused_bin_deposit_reduced_ref(d, val, order=order, grid_shape=grid,
                                                                             guard=g)),
                max_err(torch, gathered, gat_ref.fused_gather_ref(d, padded, grid_shape=grid, order=order, guard=g)))
        packed = dep.fused_bin_deposit(d, val, order=order)
        exact(torch, packed, dep_ref.fused_bin_deposit_ref(d.cpu(), val.cpu(), order=order))
        packed_z = dep_ref.column_z_pass(packed, order=order, grid_shape=grid, guard=g)
        if not torch.equal(reduced, packed_z):
            fail(f"order {order}, grid {grid}: the reduced kernel is not bit equal to the packed kernel + z pass")
        if not (torch.equal(reduced, dep.fused_bin_deposit_reduced(d, val, order=order, grid_shape=grid, guard=g))
                and torch.equal(gathered, gat.fused_bin_gather(d, padded, grid_shape=grid, order=order, guard=g))
                and torch.equal(packed, dep.fused_bin_deposit(d, val, order=order))):
            fail(f"order {order}, grid {grid}: two launches differ")
        say(f"order {order}, grid {grid}, cap {cap_e} (an all-gap and a full cell): max |kernel - plain| packed 0 "
            f"(bit for bit), reduced {errs[0]:.2e}, gather {errs[1]:.2e}; reduced == packed + z pass, launches "
            "repeat bit for bit")

    # the unfused kernels at the M x N of every stagger, on 1001 cells (no
    # block holds a whole number of them), random operands; both also at odd
    # capacities and on operands one element off a 16-byte boundary (their
    # element-copy route)
    def taps(order, stagger):
        t3 = [support(order, s)[0] for s in stagger]
        return t3[0], t3[1] * t3[2]

    def off16(x):
        """x copied to one element past a 16-byte boundary."""
        return torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)[1:].view(x.shape).copy_(x)

    def outer_check(cap_o, m, n, dtype):
        """bin_outer_product on 1001 cells, every seventh a cell all zero:
        its error against the plain version; fails unless operands off a
        16-byte boundary (the element route) and a second launch give the
        same bits"""
        a = torch.randn((n_awk, cap_o, m), generator=gen, device=dev)
        a[::7] = 0.0
        a, b = a.to(dtype), torch.randn((n_awk, cap_o, n), generator=gen, device=dev).to(dtype)
        got = dep.bin_outer_product(a, b)
        err = max_err(torch, got, dep_ref.bin_outer_product_ref(a, b))
        if not (torch.equal(dep.bin_outer_product(off16(a), off16(b)), got)
                and torch.equal(dep.bin_outer_product(a, b), got)):
            fail(f"bin_outer_product at cap {cap_o}, (M, N) ({m}, {n}), {dtype}: its copy routes or two launches "
                 "differ")
        return err

    n_awk, cap_awk = 1001, 32
    for order in (1, 2, 3):
        worst = {"bin_outer_product f32": 0.0, "bin_outer_product bf16": 0.0, "bin_gather": 0.0}
        for stagger in (NO_STAGGER,) + CURRENT_STAGGER:
            m, n = taps(order, stagger)
            for cap_o in (cap_awk, 7, 33, 48):
                for dtype, key in ((torch.float32, "bin_outer_product f32"),
                                   (torch.bfloat16, "bin_outer_product bf16")):
                    worst[key] = max(worst[key], outer_check(cap_o, m, n, dtype))
        for stagger in (NO_STAGGER,) + EB_STAGGERS:
            m, n = taps(order, stagger)
            for cap_g in (cap_awk, 7):
                wx = torch.rand((n_awk, cap_g, m), generator=gen, device=dev)
                byz = torch.rand((n_awk, cap_g, n), generator=gen, device=dev)
                gn = torch.randn((n_awk, m, n), generator=gen, device=dev)
                want = gat_ref.bin_gather_ref(wx, byz, gn)
                off = [off16(x) for x in (wx, byz, gn)]
                worst["bin_gather"] = max(worst["bin_gather"], max_err(torch, gat.bin_gather(wx, byz, gn), want),
                                          max_err(torch, gat.bin_gather(*off), want))
        say(f"order {order}, {n_awk} cells x cap {cap_awk} (bin_outer_product also caps 7, 33, 48, all-zero cells, "
            "its two copy routes and two launches bit-equal; the gather also cap 7), every stagger, aligned and off 16 "
            "bytes: max |kernel - plain| " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))
    # bin_outer_product's run-time-M instance: M outside the templated 2..5
    worst = max(outer_check(cap_o, m, n, dtype) for m, n in ((1, 4), (6, 16), (9, 5)) for cap_o in (cap_awk, 7)
                for dtype in (torch.float32, torch.bfloat16))
    say(f"bin_outer_product at (M, N) (1, 4), (6, 16) and (9, 5), {n_awk} cells x cap {cap_awk} and 7, f32 and bf16: "
        f"max |kernel - plain| {worst:.2e}; copy routes and launches bit-equal")
    # the gather's run-time-N instance: an N no stagger has, and an M over
    # the templated sums' 5
    worst = 0.0
    for m, n in ((3, 7), (6, 16)):
        for cap_g in (cap_awk, 7):
            wx = torch.rand((n_awk, cap_g, m), generator=gen, device=dev)
            byz = torch.rand((n_awk, cap_g, n), generator=gen, device=dev)
            gn = torch.randn((n_awk, m, n), generator=gen, device=dev)
            want = gat_ref.bin_gather_ref(wx, byz, gn)
            off = [off16(x) for x in (wx, byz, gn)]
            worst = max(worst, max_err(torch, gat.bin_gather(wx, byz, gn), want),
                        max_err(torch, gat.bin_gather(*off), want))
    say(f"bin_gather at (M, N) (3, 7) and (6, 16), {n_awk} cells x cap {cap_awk} and 7, aligned and off 16 bytes: "
        f"max |kernel - plain| {worst:.2e}")
    for v_, cap_, d_ in ((1001, 2, 333), (1001, 16, 1000)):
        for dtype in (torch.float32, torch.bfloat16):
            w_ = torch.randn((v_, cap_), generator=gen, device=dev).to(dtype)
            u_ = torch.randn((v_, cap_, d_), generator=gen, device=dev).to(dtype)
            err = max_err(torch, seg.segment_accumulate(w_, u_), seg_ref.segment_accumulate_ref(w_, u_))
            say(f"segment_accumulate ({v_}, {cap_}, {d_}) {str(dtype)[6:]}: max |kernel - plain| {err:.2e}")

    # -- 3b. kernels at the main path's shapes ---------------------------------
    spec = scenario("uniform", **MAIN)
    order, shape = spec.deposition.order, spec.grid.shape
    g = max_guard(order)
    t, _ = unified_support(order)
    sim0 = make_simulation(spec)
    state = sim0.state
    p = state.particles
    v = p.u / lorentz_gamma(p.u)[:, None]
    slab, val = bin_slab_staging(p.pos, v, spec.charge * p.w * p.alive.float(), state.layout, grid_shape=shape)
    d, val = slab.d, val.contiguous()
    n_occ = int(slab.valid.sum())
    # what the unfused kernels' operands are built from
    main_pos, main_layout = p.pos, state.layout
    main_qwv = (spec.charge * p.w * p.alive.float())[:, None] * v
    del sim0, state, p, v, slab
    padded = torch.randn((6, *(k + 2 * g for k in shape)), generator=gen, device=dev)
    c, cap, _ = d.shape
    nx, ny, nz = shape
    say(f"main-path shapes: {c} cells x cap {cap}, {n_occ} occupied slots, order {order} (T={t})")
    slab_bytes = 2 * d.numel() * 4
    w_flops = 6 * t * FLOPS_PER_TAP                      # six weight sets per slot
    dep_flops = n_occ * (w_flops + 3 * t + 3 * t * t + 2 * 3 * t**3)  # a, byz, 3 T^3 multiply-adds
    gat_flops = n_occ * (w_flops + 4 * t * t + 6 * (2 * t**3 + 2 * t))  # 4 byz, 6 x (H, wx-sum)
    results = {}

    def record(name, fn, plain, library, n_bytes, flops, reps, source, replaces):
        got, want = fn(), plain()
        err = max_err(torch, got, want)
        del got, want
        torch.cuda.empty_cache()
        ms = time_ms(torch, fn, reps)
        plain_ms = time_ms(torch, plain, 2)
        torch.cuda.empty_cache()
        lib_ms = library() if library is not None else None
        torch.cuda.empty_cache()
        b_ms, b_by = bound(n_bytes, flops)
        results[name] = dict(name=name, route="cuda", source=source, replaces=replaces, launches=None,
                             max_abs_err=err, ms=ms, kernel_ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=lib_ms)
        say(f"{name}: {ms:.3f} ms (plain {plain_ms:.3f} ms, library {lib_ms if lib_ms is None else f'{lib_ms:.3f} ms'}, "
            f"bound {b_ms:.3f} ms by {b_by}), max |kernel - plain| {err:.2e}")

    def deposit_operands():
        """A = w_x * val (3C, T, cap) and B = w_y (x) w_z (3C, cap, T*T),
        materialised for the bmm yardstick."""
        from repro_torch.core import shape_weights_window

        _, base = unified_support(order)
        a = torch.empty((3, c, t, cap), device=dev)
        b = torch.empty((3, c, cap, t * t), device=dev)
        for comp in range(3):
            w = [shape_weights_window(d[..., k], order, comp == k, n_taps=t, base=base) for k in range(3)]
            a[comp] = (w[0] * val[..., comp][..., None]).transpose(1, 2)
            b[comp] = (w[1][..., :, None] * w[2][..., None, :]).reshape(c, cap, t * t)
            del w
        return a.reshape(3 * c, t, cap), b.reshape(3 * c, cap, t * t)

    def deposit_library():
        """Timed once; both deposition kernels share the yardstick."""
        if "deposit" not in library_ms:
            a, b = deposit_operands()
            library_ms["deposit"] = time_ms(torch, lambda: torch.bmm(a, b), 3)
            del a, b
        return library_ms["deposit"]

    library_ms = {}

    record(
        "fused_bin_deposit_reduced", lambda: dep.fused_bin_deposit_reduced(d, val, order=order, grid_shape=shape, guard=g),
        lambda: dep_ref.fused_bin_deposit_reduced_ref(d, val, order=order, grid_shape=shape, guard=g),
        deposit_library, slab_bytes + nx * ny * 3 * (nz + 2 * g) * t * t * 4, dep_flops + c * 3 * t**3, 5,
        "src/repro_torch/csrc/fused_deposition.cu", "src/repro/kernels/deposition/kernel.py:290",
    )
    record(
        "fused_bin_deposit", lambda: dep.fused_bin_deposit(d, val, order=order),
        lambda: dep_ref.fused_bin_deposit_ref(d, val, order=order),
        deposit_library, slab_bytes + c * 3 * t**3 * 4, dep_flops, 5,
        "src/repro_torch/csrc/fused_deposition.cu", "src/repro/kernels/deposition/kernel.py:174",
    )
    # bit for bit against the plain version on the CPU, a slice of cells at
    # a time (each cell's tiles depend on that cell alone)
    packed = dep.fused_bin_deposit(d, val, order=order)
    for i in range(0, c, 1 << 18):
        sl = slice(i, i + (1 << 18))
        exact(torch, packed[sl], dep_ref.fused_bin_deposit_ref(d[sl].cpu(), val[sl].cpu(), order=order))
    del packed
    results["fused_bin_deposit"]["max_abs_err"] = 0.0
    say("main-path shapes: the packed kernel is bit equal to its plain version on the CPU")

    def gather_library():
        """H = byz . G^T for the six components as one bmm:
        (6C, cap, T*T) x (6C, T*T, T), operands materialised."""
        from repro_torch.core import EB_STAGGERS, pack_neighborhoods, packed_axis_weights

        gt = pack_neighborhoods(padded, grid_shape=shape, order=order, guard=g).transpose(2, 3)  # (C, 6, T*T, T)
        gt = gt.transpose(0, 1).reshape(6 * c, t * t, t)
        byz = torch.empty((6, c, cap, t * t), device=dev)
        w = packed_axis_weights(d, order)
        for comp, st in enumerate(EB_STAGGERS):
            byz[comp] = (w[(1, st[1])][..., :, None] * w[(2, st[2])][..., None, :]).reshape(c, cap, t * t)
        del w
        byz = byz.reshape(6 * c, cap, t * t)
        torch.cuda.empty_cache()
        ms = time_ms(torch, lambda: torch.bmm(byz, gt), 3)
        del byz, gt
        return ms

    record(
        "fused_bin_gather", lambda: gat.fused_bin_gather(d, padded, grid_shape=shape, order=order, guard=g),
        lambda: gat_ref.fused_gather_ref(d, padded, grid_shape=shape, order=order, guard=g),
        gather_library, d.numel() * 4 + padded.numel() * 4 + c * cap * 6 * 4, gat_flops, 5,
        "src/repro_torch/csrc/fused_gather.cu", "src/repro/kernels/gather/kernel.py:154",
    )
    packed_z = dep_ref.column_z_pass(dep.fused_bin_deposit(d, val, order=order), order=order, grid_shape=shape,
                                     guard=g)
    if not torch.equal(dep.fused_bin_deposit_reduced(d, val, order=order, grid_shape=shape, guard=g), packed_z):
        fail("main-path shapes: the reduced kernel is not bit equal to the packed kernel + z pass")
    say("main-path shapes: the reduced kernel is bit equal to the packed kernel followed by the plain z pass")
    del d, val, padded, packed_z
    torch.cuda.empty_cache()

    def record_sum(name, builders, reps, source, replaces):
        """A kernel's row summed over several calls (a step's launches, or
        the shapes of a path): each builder makes one call's operands and
        returns (kernel, plain, library, bytes, flops, label)."""
        row = dict(name=name, route="cuda", source=source, replaces=replaces, launches=None, max_abs_err=0.0,
                   ms=0.0, kernel_ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
        t_bytes = t_ops = 0.0
        for build_call in builders:
            fn, plain, library, n_bytes, flops, label = build_call()
            got, want = fn(), plain()
            err = max_err(torch, got, want)
            del got, want
            torch.cuda.empty_cache()
            ms, plain_ms, lib_ms = time_ms(torch, fn, reps), time_ms(torch, plain, 2), time_ms(torch, library, reps)
            b_ms, b_by = bound(n_bytes, flops)
            say(f"  {name} {label}: {ms:.3f} ms (plain {plain_ms:.3f}, library {lib_ms:.3f}, bound {b_ms:.3f} by "
                f"{b_by}), max |kernel - plain| {err:.2e}")
            row["max_abs_err"] = max(row["max_abs_err"], err)
            row["ms"] += ms
            row["plain_ms"] += plain_ms
            row["library_ms"] += lib_ms
            t_bytes, t_ops = t_bytes + n_bytes, t_ops + flops
            del fn, plain, library
            torch.cuda.empty_cache()
        row["kernel_ms"] = row["ms"]
        row["bound_ms"], row["bound_by"] = bound(t_bytes, t_ops)
        results[name] = row
        say(f"{name}, {len(builders)} calls: {row['ms']:.3f} ms (plain {row['plain_ms']:.3f} ms, library "
            f"{row['library_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms by {row['bound_by']}), "
            f"max |kernel - plain| {row['max_abs_err']:.2e}")

    # the unfused deposition: one bin_outer_product per current component
    def outer_case(k):
        def make():
            stagger = CURRENT_STAGGER[k]
            a, b = binned_shape_factors(main_pos, main_qwv[:, k].contiguous(), main_layout, grid_shape=shape,
                                        order=order, stagger=stagger)
            a, b = a.contiguous(), b.contiguous()
            m, n = a.shape[2], b.shape[2]
            return (lambda: dep.bin_outer_product(a, b), lambda: dep_ref.bin_outer_product_ref(a, b),
                    lambda: torch.bmm(a.transpose(1, 2), b), 4 * (a.numel() + b.numel() + c * m * n),
                    n_occ * 2 * m * n, f"J{'xyz'[k]} (M {m}, N {n})")
        return make

    say(f"unfused kernels at the main path's shapes ({c} cells x cap {cap}, order {order}):")
    record_sum("bin_outer_product", [outer_case(k) for k in range(3)], 3,
               "src/repro_torch/csrc/bin_outer_product.cu", "src/repro/kernels/deposition/kernel.py:70")

    # the unfused gather: one bin_gather per field component
    fields_m = torch.randn((6, *(k + 2 * g for k in shape)), generator=gen, device=dev)
    cells_m = cell_coords(c, shape, device=dev)
    d_m = slot_gather(main_pos, main_layout.slots) - cells_m[:, None, :].float()

    def gather_case(k):
        def make():
            stagger = EB_STAGGERS[k]
            (tx, ty, tz), bases = zip(*(support(order, st) for st in stagger))
            neigh = extract_neighborhoods(fields_m[k], shape, taps=(tx, ty, tz), bases=bases, guard=g)
            neigh = neigh.reshape(c, tx, ty * tz).contiguous()
            wx = shape_weights(d_m[..., 0], order, stagger[0]).contiguous()
            wy, wz = (shape_weights(d_m[..., ax], order, stagger[ax]) for ax in (1, 2))
            byz = (wy[..., :, None] * wz[..., None, :]).reshape(c, cap, ty * tz).contiguous()
            del wy, wz
            m, n = tx, ty * tz
            return (lambda: gat.bin_gather(wx, byz, neigh), lambda: gat_ref.bin_gather_ref(wx, byz, neigh),
                    lambda: torch.sum(wx * torch.bmm(byz, neigh.transpose(1, 2)), dim=-1),
                    4 * (wx.numel() + byz.numel() + neigh.numel() + c * cap), n_occ * 2 * m * (n + 1),
                    f"{('Ex', 'Ey', 'Ez', 'Bx', 'By', 'Bz')[k]} (M {m}, N {n})")
        return make

    record_sum("bin_gather", [gather_case(k) for k in range(6)], 3,
               "src/repro_torch/csrc/bin_gather.cu", "src/repro/kernels/gather/kernel.py:67")
    del fields_m, cells_m, d_m, main_pos, main_layout, main_qwv
    torch.cuda.empty_cache()

    # segment_accumulate at the two language-model shapes, bfloat16
    def lm_items():
        """(label, indices, updates, weights, capacity, n_bins) of the MoE
        combine and the embedding gradient, made from seed 0."""
        rng = np.random.default_rng(0)
        t_moe = MOE["tokens"] * MOE["top_k"]
        moe = ("MoE combine, mixtral_8x22b", torch.arange(MOE["tokens"], device=dev).repeat_interleave(MOE["top_k"]),
               torch.randn((t_moe, MOE["d"]), generator=gen, device=dev).to(torch.bfloat16),
               torch.rand((t_moe,), generator=gen, device=dev).to(torch.bfloat16), MOE["top_k"], MOE["tokens"])
        zipf = 1.0 / np.arange(1, EMBED["vocab"] + 1)   # rank-frequency of word ids
        ids = rng.choice(EMBED["vocab"], size=EMBED["tokens"], p=zipf / zipf.sum())
        emb = ("embedding gradient, phi3_mini_3p8b", torch.from_numpy(ids).to(dev),
               torch.randn((EMBED["tokens"], EMBED["d"]), generator=gen, device=dev).to(torch.bfloat16), None,
               EMBED["capacity"], EMBED["vocab"])
        return moe, emb

    def segment_case(item):
        def make():
            label, idx, upd, wts, capacity, n_bins = item
            w, u, _, _ = bin_items(idx, upd, n_bins=n_bins, capacity=capacity, weights=wts)
            w, u = w.contiguous(), u.contiguous()
            v_, cap_, d_ = u.shape
            return (lambda: seg.segment_accumulate(w, u), lambda: seg_ref.segment_accumulate_ref(w, u),
                    lambda: torch.einsum("vc,vcd->vd", w, u), 2 * (w.numel() + u.numel() + v_ * d_),
                    2 * v_ * cap_ * d_, f"{label} ({v_} bins x cap {cap_} x D {d_}, bf16)")
        return make

    items = lm_items()
    record_sum("segment_accumulate", [segment_case(it) for it in items], 5,
               "src/repro_torch/csrc/segment_accumulate.cu", "src/repro/kernels/scatter_matrix/kernel.py:37")
    torch.cuda.empty_cache()

    # -- 4. the main path at full size -----------------------------------------
    # from here on no path but phase 6's forced torch, phase 14's ladder
    # and phase 18's differentiated paths may resolve to a plain version
    # (the comparisons above call them)
    dispatch.counters["plain_on_card"] = 0
    sim = make_simulation(scenario("uniform", **MAIN))
    chosen = resolved(dispatch, sim)
    say(f"main path: the dispatcher resolved {chosen}")
    charge0 = float(torch.sum(sim.state.particles.w * sim.state.particles.alive))
    main = run_path(torch, kernels, sim, f"main path: uniform {MAIN['grid']}, order {MAIN['order']}")
    counts, steps, n0 = main["counts"], main["steps"], main["n0"]
    diag = sim.diagnostics()
    charge1 = float(torch.sum(sim.state.particles.w * sim.state.particles.alive))
    say(f"  energies: field {diag['field_energy']:.6e} kinetic {diag['kinetic_energy']:.6e} "
        f"total {diag['total_energy']:.6e}; charge {charge0:.7e} -> {charge1:.7e}")
    per_run = steps + main["captures"]  # each capture's warm-up step launches too
    want = path_launches(chosen, per_run)
    if fused_counts(counts) != want:
        fail(f"the main path did not launch the resolved backends' kernels ({chosen}) once per step: {counts}")
    if not all(math.isfinite(diag[k]) for k in ("field_energy", "kinetic_energy")) or diag["field_energy"] <= 0:
        fail(f"energies not finite and positive: {diag}")
    if diag["step"] != steps or diag["n_alive"] != n0 or abs(charge1 - charge0) > 1e-5 * abs(charge0):
        fail("step count, particle count or total charge not conserved")
    for name, n in want.items():
        results[name]["launches"] = n
    main_final = host_copy(sim)  # phases 16 and 19 hold the ensemble's first member and a repeat run to it
    del sim
    torch.cuda.empty_cache()

    # the same path through each fused deposition kernel the autotune did
    # not pick (16 steps)
    forced = {}
    for backend in ("cuda", "cuda_reduced"):
        if chosen["deposit_fused"] == backend:
            continue
        sim = make_simulation(scenario("uniform", **{**MAIN, "steps": 16}, backend=backend))
        out = run_path(torch, kernels, sim, f"main path, backend {backend}")
        want = path_launches(resolved(dispatch, sim), 16 + out["captures"])
        if fused_counts(out["counts"]) != want:
            fail(f"backend {backend} did not run its kernels once per step: {out['counts']}")
        for name, n in want.items():
            if results[name]["launches"] is None:
                results[name]["launches"] = n
        forced[backend] = out
        say(f"  against the main path ({chosen['deposit_fused']}): {out['ms_step'] / main['ms_step']:.3f}x its step time")
        del sim
        torch.cuda.empty_cache()

    # -- 5. the unfused path and the scatter baseline at full size -------------
    sim = make_simulation(scenario("uniform", **UNFUSED))
    out = run_path(torch, kernels, sim, "unfused path: matrix_unfused deposition and gather")
    per_run = out["steps"] + out["captures"]
    if out["counts"].get("bin_outer_product") != 3 * per_run or out["counts"].get("bin_gather") != 6 * per_run:
        fail(f"the unfused path did not launch bin_outer_product 3 and bin_gather 6 times a step: {out['counts']}")
    diag = sim.diagnostics()
    if not (math.isfinite(diag["total_energy"]) and diag["n_alive"] == out["n0"] and diag["field_energy"] > 0):
        fail(f"unfused run not sane: {diag}")
    results["bin_outer_product"]["launches"] = out["counts"]["bin_outer_product"]
    results["bin_gather"]["launches"] = out["counts"]["bin_gather"]
    say(f"  against the fused main path: {out['ms_step'] / main['ms_step']:.2f}x its step time, "
        f"{out['peak_gb'] / main['peak_gb']:.2f}x its peak memory")
    del sim
    torch.cuda.empty_cache()

    sim = make_simulation(scenario("uniform", **SCATTER))
    out = run_path(torch, kernels, sim, "scatter baseline: scatter deposition and gather")
    if out["counts"]:
        fail(f"the scatter baseline launched a bin kernel: {out['counts']}")
    diag = sim.diagnostics()
    if not (math.isfinite(diag["total_energy"]) and diag["n_alive"] == out["n0"] and diag["field_energy"] > 0):
        fail(f"scatter run not sane: {diag}")
    say(f"  the fused main path against this baseline: {out['ms_step'] / main['ms_step']:.2f}x faster a step")
    del sim
    torch.cuda.empty_cache()
    no_plain(dispatch, "phases 4-5")

    # -- 6. the other backends and modes at 32^3 against the default -----------
    fields = {}
    runs = {"cuda_reduced": dict(backend="cuda_reduced"), "cuda": dict(backend="cuda"), "torch": dict(backend="torch"),
            "matrix_unfused": dict(deposition="matrix_unfused", gather="matrix_unfused"),
            "scatter": dict(deposition="scatter", gather="scatter"),
            "rhocell": dict(deposition="rhocell", gather="scatter")}
    for label, kw in runs.items():
        kernels.reset_launch_counts()
        sim = make_simulation(scenario("uniform", grid=(32, 32, 32), ppc=2, order=3, steps=8, window=4, **kw))
        sim.run()
        fields[label] = [f.clone() for f in sim.state.fields.all()]
        say(f"32^3 {label}: sorts {sim.sorts}, host reads {sim.host_reads} in {sim.windows} windows, launches "
            f"{ {k: v for k, v in kernels.launch_counts().items() if v} }, energies {sim.diagnostics()['total_energy']:.6e}")
        if sim.host_reads != sim.windows + 2 * sim.growths["capacity"]:
            fail(f"32^3 {label}: not one host read a window")
        if label == "torch":  # the one path that asks for the plain version
            dispatch.counters["plain_on_card"] = 0
        no_plain(dispatch, f"32^3 {label}")
    for label in runs:
        if label == "cuda_reduced":
            continue
        worst = 0.0
        for a, b in zip(fields[label], fields["cuda_reduced"]):
            worst = max(worst, float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30))
        say(f"32^3 fields, {label} against cuda_reduced after 8 steps: max |diff| / max |field| = {worst:.2e} "
            f"(tolerance 1e-4: the routes sum in different orders, compounded over the steps)")
        if worst > 1e-4:
            fail(f"{label} disagrees with the default path")

    # -- 7. lwfa at its registry size -------------------------------------------
    sim = make_simulation(scenario("lwfa"))
    p = sim.state.particles
    charge0 = float(torch.sum(p.w * p.alive))
    out = run_path(torch, kernels, sim, f"lwfa {sim.config.grid.shape}, capacity {sim.config.capacity}", 20)
    diag = sim.diagnostics()
    p = sim.state.particles
    charge1 = float(torch.sum(p.w * p.alive))
    say(f"  {out['n0']} live of {p.n} particles, energies field {diag['field_energy']:.6e} "
        f"kinetic {diag['kinetic_energy']:.6e}")
    if not (math.isfinite(diag["total_energy"]) and diag["n_alive"] == out["n0"] and out["n0"] < p.n
            and abs(charge1 - charge0) <= 1e-5 * abs(charge0) and diag["field_energy"] > 0):
        fail(f"lwfa run not sane: {diag}")
    chosen_l = resolved(dispatch, sim)
    say(f"  resolved {chosen_l}")
    if any(out["counts"].get(k, 0) < n for k, n in path_launches(chosen_l, out["steps"]).items()):
        fail(f"lwfa did not launch the resolved kernels {chosen_l} every step: {out['counts']}")
    no_plain(dispatch, "lwfa")
    del sim
    torch.cuda.empty_cache()

    # -- 8. matrix_scatter_add at the language-model shapes ----------------------
    # in float32 (the kernel rows above are bfloat16), against a float32
    # scatter-add of the same items: the two sum in different orders; the
    # default backend ("auto"), which must resolve to the kernel, untimed
    kernels.reset_launch_counts()
    bench0 = dispatch.counters["benchmark"]
    for label, idx, upd, wts, capacity, n_bins in items:
        upd32 = upd.float()
        w32 = None if wts is None else wts.float()
        chosen_seg = dispatch.resolve("segment_accumulate", "auto", device=dev, capacity=capacity, n_bins=n_bins,
                                      dtype=upd32.dtype, width=upd32.shape[1])
        say(f"matrix_scatter_add, {label}: auto resolves segment_accumulate to {chosen_seg!r}")
        if chosen_seg != "cuda":
            fail(f"auto resolved segment_accumulate to {chosen_seg!r} at {label}, not the kernel")
        got = matrix_scatter_add(idx, upd32, n_bins=n_bins, capacity=capacity, weights=w32)
        ones = torch.ones(idx.shape, device=dev)
        want = torch.zeros((n_bins, upd.shape[1]), device=dev).index_add_(
            0, idx, (ones if w32 is None else w32)[:, None] * upd32)
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        n_over = int((torch.bincount(idx, minlength=n_bins) > capacity).sum())
        say(f"matrix_scatter_add, {label}: {n_over} bins overflow capacity {capacity}, "
            f"max |path - scatter-add| {err:.3e} of max |out| {scale:.3e}")
        if not math.isfinite(err) or err > RTOL * scale:
            fail(f"matrix_scatter_add disagrees with the scatter-add: {label}")
        del got, want, upd32
    n_seg = kernels.launch_counts()["segment_accumulate"]
    if n_seg != len(items) or dispatch.counters["benchmark"] != bench0:
        fail(f"matrix_scatter_add did not launch segment_accumulate once per call ({n_seg}), or timed it")
    no_plain(dispatch, "matrix_scatter_add")
    results["segment_accumulate"]["launches"] = n_seg

    # -- 9. the sort-mode ablation at the main shapes ---------------------------
    ablation = {}
    for mode, kw, n_timed in (("rebuild", {}, 8), ("global", {}, 8),
                              ("none", dict(deposition="scatter", gather="scatter"), 4)):
        sim = make_simulation(scenario("uniform", **{**MAIN, "window": n_timed}, sort=mode, **kw))
        t0 = time.perf_counter()
        out = run_path(torch, kernels, sim, f"sort {mode}{' (scatter deposition and gather)' if kw else ''}",
                       n_timed, warmup=n_timed)
        per_run = out["steps"] + out["captures"]
        want = path_launches(resolved(dispatch, sim), per_run)
        if out["counts"] != want:
            fail(f"sort {mode}: launches {out['counts']}, expected {want} (resolved {resolved(dispatch, sim)})")
        if out["reads_per_window"] != 1.0 or sim.sorts or sim.rebuilds:
            fail(f"sort {mode}: {out['reads_per_window']} host reads a window, {sim.sorts} sorts, "
                 f"{sim.rebuilds} rebuilds: expected 1.0 and no policy sort")
        diag = sim.diagnostics()
        if not (math.isfinite(diag["total_energy"]) and diag["n_alive"] == out["n0"] and diag["field_energy"] > 0):
            fail(f"sort {mode}: run not sane: {diag}")
        ablation[mode] = out
        say(f"  against incremental (phase 4): {out['ms_step'] / main['ms_step']:.3f}x its step time "
            f"({out['ms_step']:.2f} against {main['ms_step']:.2f} ms/step), {out['peak_gb'] / main['peak_gb']:.2f}x "
            f"its peak memory; phase {time.perf_counter() - t0:.1f} s")
        del sim
        torch.cuda.empty_cache()
    say("ablation (ms/step steady | with set-up | particle-steps/s | peak GB | host reads/window | ratio): "
        + "; ".join(f"{m} {o['ms_step']:.2f} | {o['ms_step_setup']:.2f} | {o['rate']:.4e} | {o['peak_gb']:.2f} | "
                    f"{o['reads_per_window']:.2f} | {o['ms_step'] / main['ms_step']:.3f}"
                    for m, o in [("incremental", main)] + list(ablation.items())))
    no_plain(dispatch, "the sort-mode ablation")

    # -- 10. the host-driven loop ------------------------------------------------
    sim = make_simulation(scenario("uniform", **MAIN))
    chosen_host = resolved(dispatch, sim)
    sim.run(1, window=None)  # first-call allocations
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    reads0 = sim.host_reads
    t0 = time.perf_counter()
    sim.run(8, window=None)
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / 8
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    host_reads = (sim.host_reads - reads0) / 8
    say(f"host-driven loop, main path: 8 steps at {host_ms:.2f} ms/step ({host_ms / main['ms_step']:.3f}x the "
        f"windowed {main['ms_step']:.2f}), {host_reads:.2f} host reads/step, sorts {sim.sorts}, launches {counts}, "
        f"{sim.graph_captures} graph captures, resolved {chosen_host}")
    if counts != path_launches(chosen_host, 8) or sim.graph_captures or sim.windows:
        fail(f"the host-driven loop did not run each kernel once a step without a graph: {counts}")
    del sim
    torch.cuda.empty_cache()
    small = dict(grid=(32, 32, 32), ppc=2, order=3, policy=SortPolicyConfig(sort_interval=7, min_sort_interval=3,
                                                                          sort_trigger_perf_enable=False))
    host, wind = make_simulation(scenario("uniform", **small)), make_simulation(scenario("uniform", **small))
    host.run(20, window=None)
    wind.run(20, window=10)
    if not same_state(torch, host, wind, policy=False) or host.sorts < 2:
        fail(f"32^3: 20 host-loop steps are not bit-equal to 20 windowed steps (sorts {host.sorts}, {wind.sorts})")
    say(f"32^3: 20 host-loop steps bit-equal to 20 windowed steps: fields, particles, slots, slab, "
        f"sorts {host.sorts}, rebuilds {host.rebuilds}; host reads {host.host_reads} against {wind.host_reads}")
    del host, wind
    no_plain(dispatch, "the host-driven loop")

    # -- 11. checkpoints on the card -------------------------------------------
    import shutil

    ckpt = ROOT / "build" / "chip_smoke_checkpoint"
    try:
        for mode in ("incremental", "global"):
            kw = dict(small, sort=mode, window=5, diagnostics_every=1)
            whole = make_simulation(scenario("uniform", **kw))
            whole.run(20)
            first = make_simulation(scenario("uniform", **kw))
            first.run(10)
            first.save(str(ckpt))
            kernels.reset_launch_counts()
            resumed = load_simulation(str(ckpt))
            resumed.run(10)
            counts = {k: v for k, v in kernels.launch_counts().items() if v}
            if not same_state(torch, whole, resumed) or whole.history != resumed.history:
                fail(f"sort {mode}: saved at step 10, loaded and run 10 more steps is not bit-equal to 20 steps")
            want = path_launches(resolved(dispatch, resumed), 10 + resumed.graph_captures)
            if fused_counts(counts) != want:
                fail(f"sort {mode}: the resumed run did not launch the resolved kernels {want}: {counts}")
            say(f"checkpoint, sort {mode}, 32^3: saved at step 10, loaded, 10 more steps bit-equal to 20 "
                f"uninterrupted steps (sorts {whole.sorts}, history of {len(whole.history)} steps, resolved "
                f"{resolved(dispatch, resumed)})")
            del whole, first, resumed
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    no_plain(dispatch, "checkpoints")

    # -- 12. growth-rate anchors ------------------------------------------------
    for name, rate in (("two_stream", two_stream_growth_rate), ("weibel", weibel_growth_rate)):
        spec_g = scenario(name)
        kernels.reset_launch_counts()
        sim = make_simulation(spec_g)
        sim.run()
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        gamma = rate(spec_g)
        slope = energy_slope(np, sim.history, spec_g.dt)
        ratio = slope / (2.0 * gamma)
        chosen_g = resolved(dispatch, sim)
        say(f"{name} {spec_g.grid.shape}, {spec_g.run.steps} steps: field-energy growth {slope:.4f} against the "
            f"analytic 2*gamma {2 * gamma:.4f}: ratio {ratio:.3f} (window 0.75-1.25), launches {counts}, "
            f"resolved {chosen_g}")
        if not 0.75 < ratio < 1.25 or any(not counts.get(k) for k in path_launches(chosen_g, 1)):
            fail(f"{name}: growth ratio {ratio:.3f} outside 0.75-1.25, or the resolved kernels did not run")
        del sim
    no_plain(dispatch, "growth-rate anchors")

    # -- 13. the PM N-body example ------------------------------------------------
    import importlib.util

    spec_pm = importlib.util.spec_from_file_location(
        "torch_pm_nbody", ROOT / "examples" / "torch_pm_nbody.py")
    pm = importlib.util.module_from_spec(spec_pm)
    spec_pm.loader.exec_module(pm)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = pm.run(4096, 40, device=dev, log=lambda line: say(f"  pm_nbody {line}"))
    pm_s = time.perf_counter() - t0
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    say(f"torch_pm_nbody: 4096 bodies, 16^3, 40 steps in {pm_s:.3f} s, launches {counts}, largest |deposited mass "
        f"- total| {out['mass_err']:.2e}, bin rebuilds {out['rebuilds']}, capacity growths {out['growths']}")
    energies = out["kinetic"] + out["potential"]
    if counts.get("bin_outer_product", 0) < 40 or counts.get("bin_gather", 0) < 120:
        fail(f"torch_pm_nbody did not launch bin_outer_product and bin_gather every step: {counts}")
    if not all(math.isfinite(e) for e in energies) or out["mass_err"] > 1e-5:
        fail(f"torch_pm_nbody: energies not finite or mass not conserved ({out['mass_err']:.2e})")
    no_plain(dispatch, "torch_pm_nbody")

    # -- 14. fault tolerance on the card ------------------------------------------
    t0 = time.perf_counter()
    sim = make_simulation(scenario("uniform", **MAIN))
    off = run_path(torch, kernels, sim, "sentinel off, main shapes")
    clean = host_copy(sim)
    del sim
    torch.cuda.empty_cache()
    sim = make_simulation(scenario("uniform", **MAIN, health={"enable": True}))
    on = run_path(torch, kernels, sim, "sentinel on, no fault, main shapes")
    if not same_state(torch, sim, clean) or sim.halts or sim.retries or on["reads_per_window"] != 1.0:
        fail(f"sentinel on: not bit-equal to the sentinel off, or halts {sim.halts}, {on['reads_per_window']} reads "
             "a window")
    snap_bytes = sum(getattr(t, f).numel() * getattr(t, f).element_size() for t in sim._snapshot["trees"]
                     for f in t.__dataclass_fields__)
    snap_ms = time_ms(torch, sim._take_snapshot, 5)
    say(f"  bit-equal to the sentinel off; {on['ms_step']:.2f} against {off['ms_step']:.2f} ms/step "
        f"({on['ms_step'] / off['ms_step'] - 1:+.2%}), peak {on['peak_gb']:.2f} against {off['peak_gb']:.2f} GB, "
        f"{on['reads_per_window']:.2f} host reads a window (off {off['reads_per_window']:.2f}); the snapshot "
        f"{snap_bytes / 1e9:.3f} GB, copied in {snap_ms:.3f} ms a window ({snap_ms / MAIN['window']:.4f} ms a step)")
    del sim
    torch.cuda.empty_cache()
    for fault, want_halts in ((dict(kind="nan_field", step=20, component="ez"), {"nonfinite": 1}),
                              (dict(kind="charge_scale", step=20), {"invariant": 1})):
        sim = make_simulation(scenario("uniform", **MAIN, health={"enable": True}, fault=fault))
        out = run_path(torch, kernels, sim, f"{fault['kind']} at step 20, main shapes")
        ok = same_state(torch, sim, clean) and sim.history == clean.history
        say(f"  halts {sim.halts}, retries {sim.retries}, fired {sim.fault_injector.fired}, host reads "
            f"{sim.host_reads} in {sim.windows} windows entered (one halted), bit-equal to the clean run: {ok}; "
            f"{out['ms_step']:.2f} ms/step against {on['ms_step']:.2f} clean")
        if (sim.halts != want_halts or sim.retries != 1 or sim.fault_injector.fired != 1 or not ok
                or sim.host_reads != sim.windows):
            fail(f"{fault['kind']}: expected one halt {want_halts}, one retry and a bit-equal final state")
        del sim
        torch.cuda.empty_cache()
    del clean
    no_plain(dispatch, "the sentinel and the rolled-back faults")

    small_ft = dict(grid=(32, 32, 32), ppc=2, order=3, steps=12, window=6, diagnostics_every=3)
    sim = make_simulation(scenario("uniform", **small_ft, backend="cuda_reduced",
                                   health={"enable": True, "max_retries": 6},
                                   fault={"kind": "nan_field", "step": 4, "component": "ex", "count": 0}))
    ladder, demote = ["cuda_reduced"], sim._demote_backend

    def logged_demote():
        moved = demote()
        if moved:
            ladder.append(sim.config.backend)
        return moved

    sim._demote_backend = logged_demote
    try:
        sim.run()
        fail("a persistent NaN did not end in SimulationHealthError")
    except SimulationHealthError as e:
        err = e
    say(f"persistent nan_field, 32^3: SimulationHealthError halt {err.halt!r} at step {err.step}, invariant "
        f"{err.invariant!r}, measured {err.measured}, retries {err.retries}; backends {' -> '.join(ladder)}")
    demoted = dispatch.counters["plain_on_card"]
    say(f"  the demotion to torch is counted: {demoted} resolution(s) ran the plain version on the card")
    if ((err.halt, err.step, err.invariant, err.retries) != ("nonfinite", 5, "fields_nonfinite", 6)
            or ladder != ["cuda_reduced", "cuda", "torch"] or sim.config.backend != "torch" or not err.measured > 0
            or not demoted):
        fail("the remedy ladder did not end on torch with the CPU's halt, step, invariant and retries, "
             "or the move to the plain version went uncounted")
    dispatch.counters["plain_on_card"] = 0
    del sim._demote_backend, sim  # (the logging wrapper referred to the driver)
    auto = ROOT / "build" / "chip_smoke_autosave"
    try:
        shutil.rmtree(auto, ignore_errors=True)
        whole = make_simulation(scenario("uniform", **small_ft, health={"enable": True}))
        whole.run()
        crash = make_simulation(scenario("uniform", **small_ft, health={"enable": True},
                                         fault={"kind": "crash", "step": 8}))
        crash.run(autosave_every=6, autosave_path=str(auto))
        ok = same_state(torch, whole, crash) and whole.history == crash.history
        say(f"crash at step 8, 32^3, autosave every 6: restarts {crash.restarts}, bit-equal to the uninterrupted run: "
            f"{ok}; autosaves {sorted(os.listdir(auto))}")
        if crash.restarts != 1 or not ok:
            fail("the crash was not restored from its autosave bit for bit")
        del whole, crash
    finally:
        shutil.rmtree(auto, ignore_errors=True)
    torch.cuda.empty_cache()
    say(f"phase 14: {time.perf_counter() - t0:.1f} s")

    # -- 15. the dispatcher's autotune -----------------------------------------------
    # on the card auto chooses among the kernels only: deposit_fused times
    # cuda_reduced (#2 and its tail) against cuda (#1 and the z pass) on a
    # slab at the driver's mean occupancy; every other op has one kernel
    t0 = time.perf_counter()
    for order in (1, 2):  # the other orders at the main grid, for their timings
        sim = make_simulation(scenario("uniform", **{**MAIN, "order": order}))
        del sim
        torch.cuda.empty_cache()
    entries = json.loads(AUTOTUNE_CACHE.read_text())["entries"]
    flips = []
    for key, e in sorted(entries.items()):
        say(f"autotune {key}, fill {e['fill']}: medians "
            + ", ".join(f"{n} {us / 1e3:.3f} ms" for n, us in e["timings_us"].items()) + f"; winner {e['backend']}")
        if set(e["timings_us"]) != {"cuda_reduced", "cuda"}:
            fail(f"autotune {key}: candidates {sorted(e['timings_us'])}, expected the two deposition kernels")
        if e["backend"] != "cuda_reduced":
            flips.append(key)
    say(f"autotune: {len(entries)} keys timed in this run; the timing overruled the priority order "
        f"(cuda_reduced) at {len(flips)}: {flips}")
    spec_main = scenario("uniform", **MAIN)
    cap_main = spec_main.sort.resolved_capacity(spec_main.plasma.ppc)
    main_key = dict(device=dev, order=MAIN["order"], grid_shape=MAIN["grid"], capacity=cap_main, dtype=torch.float32)
    # the seconds the timing adds to set-up: the main key timed from an
    # empty cache and a cold memo, then resolved from the memo
    AUTOTUNE_CACHE.unlink()
    dispatch.clear_memo()
    dispatch.reset_counters()
    t1 = time.perf_counter()
    sim = make_simulation(spec_main)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t1
    del sim
    torch.cuda.empty_cache()
    n_bench = dispatch.counters["benchmark"]
    t1 = time.perf_counter()
    sim = make_simulation(spec_main)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t1
    memo = dispatch.counters["memo_hit"]
    del sim
    torch.cuda.empty_cache()
    dispatch.clear_memo()
    again = {op: dispatch.resolve(op, "auto", **main_key) for op in ("deposit_fused", "gather_fused")}
    e = json.loads(AUTOTUNE_CACHE.read_text())["entries"][dispatch.make_key("deposit_fused", **main_key).cache_key()]
    say(f"autotune deposit_fused, main shapes, timed again (fill {e['fill']}): medians "
        + ", ".join(f"{n} {us / 1e3:.3f} ms" for n, us in e["timings_us"].items()) + f"; winner {e['backend']}")
    say(f"set-up of the main path: {cold_s:.2f} s timing from nothing ({n_bench} benchmark), {warm_s:.2f} s from the "
        f"memo: the timing adds {cold_s - warm_s:.2f} s; after clear_memo: {again} ({dispatch.counters['cache_hit']} "
        f"cache hit, gather_fused untimed: one kernel), {dispatch.counters['benchmark']} benchmark in all")
    if (n_bench != 1 or dispatch.counters["benchmark"] != 1 or memo < 2 or dispatch.counters["cache_hit"] != 1
            or again["gather_fused"] != "cuda"):
        fail("the autotune timed a key more than once, timed the gather, or the memo or the cache file were not used")
    sim = make_simulation(spec_main)
    chosen15 = resolved(dispatch, sim)
    out = run_path(torch, kernels, sim, f"main path under the resolved backends {chosen15}")
    if fused_counts(out["counts"]) != path_launches(chosen15, out["steps"] + out["captures"]):
        fail(f"the main path did not launch the resolved kernels {chosen15} once a step: {out['counts']}")
    say(f"  against phase 4: {out['ms_step']:.2f} against {main['ms_step']:.2f} ms/step; phase 15: "
        f"{time.perf_counter() - t0:.1f} s")
    del sim
    torch.cuda.empty_cache()
    no_plain(dispatch, "the autotune")

    # -- 16. ensembles on the card ----------------------------------------------------
    t0 = time.perf_counter()
    ensemble_phase(torch, np, kernels, dispatch, dev, main, main_final, chosen, dep, gat)
    torch.cuda.empty_cache()
    no_plain(dispatch, "ensembles")
    say(f"phase 16: {time.perf_counter() - t0:.1f} s")

    # -- 17. the simulation service on the card ------------------------------------------
    t0 = time.perf_counter()
    service_phase(torch, dev)
    torch.cuda.empty_cache()
    no_plain(dispatch, "the service")
    say(f"phase 17: {time.perf_counter() - t0:.1f} s")

    # -- 18. the gradient subsystem on the card ------------------------------------------
    t0 = time.perf_counter()
    grad_phase(torch, kernels, dispatch, dev)
    # its differentiated paths run the plain route on the card, as the
    # reference's run its xla route; the kernels' path in (b) ran none
    dispatch.counters["plain_on_card"] = 0
    torch.cuda.empty_cache()
    say(f"phase 18: {time.perf_counter() - t0:.1f} s")

    # -- 19. the distributed driver on the card ----------------------------------------------
    t0 = time.perf_counter()
    dist_phase(torch, np, kernels, dispatch, dev, main_final)
    del main_final
    say(f"phase 19: {time.perf_counter() - t0:.1f} s")

    # -- 20. the language-model stack on the card ---------------------------------------------
    t0 = time.perf_counter()
    lm_phase(torch, dev, smi)
    say(f"phase 20: {time.perf_counter() - t0:.1f} s")

    # -- 21. language-model training on the card ---------------------------------------------
    t0 = time.perf_counter()
    train_phase(torch, np, dispatch, dev, smi)
    say(f"phase 21: {time.perf_counter() - t0:.1f} s")
    AUTOTUNE_CACHE.unlink(missing_ok=True)

    say(f"total {time.perf_counter() - t_start:.1f} s")
    order_of = ("fused_bin_deposit", "fused_bin_deposit_reduced", "fused_bin_gather", "bin_outer_product",
                "bin_gather", "segment_accumulate")
    say(json.dumps({"kernels": [results[k] for k in order_of]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
