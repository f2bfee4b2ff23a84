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
16. ensembles on the card, a bucket's step taken once over its member
   axis: (a) `make_ensemble(EnsembleSpec.replicate(main, 2))` at the main
   shapes, one bucket advanced through one captured graph a window step:
   each member bit-equal (fields, particles, slots, slab, policy state,
   sorts, rebuilds) to its own solo windowed run (member 0's is phase 4's
   run), 1.00 host read a window, one capture, each kernel the bucket
   resolves at batch 2 launched once a bucket step (one launch covers both
   members); ms per member-step against phase 4's ms/step and peak
   memory; (b) the sweep of docs/ensemble.md, `two_stream` at its registry
   size with `--sweep drift=0.1,0.2,0.3 --ensemble 4` (12 members, one
   bucket, 300 steps): every member bit-equal to its solo run, one read a
   window, one capture, the bucket's ms per window and host reads against
   the 12 solo runs back to back, the kernels one replay runs for the
   bucket's step against one member's solo step;
   every member's field energy within 0.5 decades (window means, linear
   phase) of the cold linear solution of its own seed, and its fitted
   growth within 0.75-1.25 of the seeded mode's analytic rate wherever the
   same fit finds that rate in the linear solution (the drift-0.2
   replicas: at 0.1 and 0.3 the fit's window opens on the velocity seed's
   transient, in the linear solution as well);
   (c) each of #1-#5 given three members, one launch bit-equal to three
   launches of one member each, at 32^3 (orders 1-3) and at the sweep's
   member shape 4x4x64 (order 1);
   (d) growth isolation, tests/test_torch_ensemble.py's members (6^3,
   order 1, capacity 12, one hot member at u_th 0.5, two mild at 0.02, 28
   steps, window 7): the hot member bit-equal to its solo run, which grows
   the same way, the mild siblings bit-equal to solo runs that never grow,
   each fused kernel giving the same bits at capacities 12 and 24 with the
   same occupied slots, captures one plus one a growth;
   (e) member checkpoints at 32^3: `save_member(1)` at step 8,
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
   on the card in this phase;
22. the language-model stack's distributed pieces, every mesh axis held on
   the card (plain PyTorch ops, no kernel of the port's), TF32 off: (a)
   21(d)'s initial state and batches under the rules of a (2, 2) (data,
   model) mesh (`rules_for`), 3 steps through the `Supervisor`: the losses
   bit-equal to 21(d)'s first 3, with no argsort in them (the embedding
   backward adds its rows unsorted under rules; alone at the same shapes
   its gradient is bit-equal to the pre-sorted one's), ms a step and peak
   memory; (b) GPipe
   (`distributed.pipeline`): phi3-mini-3.8b's 32 periods as 4 stages of 8,
   views of the layer stack, 8 microbatches of 1 x 512 bf16 hidden states
   through the model's own block, no grad: bit-equal to the sequential
   composition of the stages, both timed beside the schedule's 44/32 stage
   calls; check B's shapes (tests/dist_lm_check.py: 4 stages, 8
   microbatches of 4 x 16, tanh(x @ w)) within 1e-5 of the sequential
   composition; (c) the int8 error-feedback all-reduce
   (`distributed.compression`): check C (8 stacked data shards, 60 AdamW
   steps of a 16x16 linear model, examples/torch_dist_lm.py) meeting the
   reference's two criteria on the card, its losses printed beside the
   CPU's; one reduction of the same stacked grads and residuals (float32
   and bfloat16) bit-equal card against CPU in the compressed mean, the
   residuals and the exact mean; one phi3-mini-3.8b period's gradient
   leaves in bf16 over 8 shards with float32 residuals: the compressed and
   the exact reduction timed, the int8 payload's bytes, and the
   error-feedback identity n * mean + sum(new_r) = sum(g + r) within 4
   float32 roundings of sum|g + r| + n|mean|;
23. the functional faces: (a) `pic_run_window` at the main cell, 16
   steps, ``donate=False``, twice from one state: each call bit-equal to a
   `Simulation` window of 16 steps (state, policy state, per-step rows,
   sorts), the second under ``torch.cuda.set_sync_debug_mode("error")``
   with no capture, the resolved fused kernels launched 16 times a call;
   ms/step beside phase 4's; then ``n_target`` a device tensor of 5,
   bit-equal to 5 steps; (b) `ensemble_run_window` over the 12 two_stream
   sweep members of 16(b), stacked, 25 steps with targets 25 and 10 in
   turn: every member bit-equal to its solo run, each of two
   `make_ensemble_window_fn` callables capturing once, a third call under
   the sync debug mode; (c) `make_dist_window` at the main cell on 4x2, 16
   steps, twice (the second under the sync debug mode, no capture),
   bit-equal to a `DistSimulation` window, and 4 steps of `make_dist_step`
   bit-equal to `DistSimulation.run(4, window=None)`. The card's name and
   power limit are printed beside each time;
24. the distributed driver over ranks, one process a rank: (a) an NCCL
   group of one rank, joined through a ``FileStore`` under build/
   (`make_pic_mesh` over it is the one-process stack), and a `RankGrid`
   built on it, which runs every reduction as a real NCCL all-gather, in
   the captured window's IF bodies too (the ring shifts stay local rolls,
   one rank an axis): phase 19's main cell (4x2 at 128^3, order 3, 2^3 a
   cell, phase 19's window of 16 and its 16 timed steps) through
   `make_simulation(spec, mesh=...)`, the all-gathers counted as issued
   eagerly and into the capture, bit-equal to phase 19's run (SHA-256 of
   every state tensor of the global view, the policy state, the counters
   and the history), its ms/step beside phase 19's, one capture, 1.00
   host read a window, the resolved fused kernels launched once a shard a
   step; (b) where two or
   more cards are visible, ``min(count, 4)`` spawned ranks, one card each,
   on the same cell, bit-equal to (a), with ms/step and the peak GB of
   each card; with one card a line says that (b) did not run;
25. the LM stack's data and pipe axes over ranks, one process a rank (plain
   PyTorch ops and NCCL, no kernel of the port's): (a) an NCCL group of one
   rank, joined through a ``FileStore`` under build/, whose collectives are
   real and counted (`AxisRanks.counts` and the `torch.distributed` calls):
   21(d)'s phi3-mini-3.8b at full width, its first 3 steps through the
   data-parallel step (`make_train_step(..., ranks=...)`, the gradients
   all-gathered a 64 MiB chunk at a time and summed in rank order) and the
   `Supervisor` over the rank (a failure flag agreed a step), the losses
   bit-equal to 21(d)'s, ms a step beside 21(d)'s, peak memory, the
   reduction's ms a step and bytes; 22(c)'s compressed reduction of one
   phi3 period over 8 shards as the one rank's block, bit-equal to the
   stacked call (mean, residuals, exact mean), both timed in turns; 22(b)'s
   GPipe of phi3 as 4 stages as the one rank's block, bit-equal to the
   stacked run, both timed in three rounds of turns, with one call's host
   enqueue against its wall time; (b) where two or more cards are visible, 4 ranks (2 with 2
   or 3 cards), one card each: phi3 at one sequence a rank bit-equal to
   the one-process step at ``microbatches`` = the rank count (losses and
   the parameters' SHA-256), and the reduction and GPipe over the ranks
   bit-equal to their stacked runs; with one card a line says that (b) did
   not run;
26. the LM stack's model axis over ranks (tensor and vocabulary
   parallelism; plain PyTorch ops and NCCL, no kernel of the port's): (a)
   ``launch.train --mesh 1x1 --ranks 1``'s layout, an NCCL group of one
   rank joined through a ``FileStore`` under build/ (`mesh_ranks(1, 1)`),
   21(d)'s phi3-mini-3.8b at full width, its first 3 steps through the
   tensor-parallel step (`make_train_step` over the layout: every
   attention, MLP and vocabulary boundary issues its all-gather and sum in
   rank order, in the recompute too) and the `Supervisor` over the layout:
   the losses bit-equal to 21(d)'s, ms a step and peak GB beside 21(d)'s,
   the model axis's collectives counted a step (eager), their ms a step
   and bytes; (b) where two or more cards are visible, a 1x2 layout, one
   card a rank, phi3's losses within rounding of 21(d)'s; with one card a
   line says that (b) did not run; (c) MoE layers over the model axis:
   deepseek-moe-16b at its published widths (d 2048, 64 experts of 1408,
   2 shared, top-6, vocab 102400; bf16, float32 moments), its 28 layers
   cut to 4, 21(d)'s batch, 3 steps in one process and then through a 1x1
   layout on an NCCL group of one (`rules_for` puts the experts on
   ``model``: the expert-parallel path, every MoE boundary's collective
   run): the losses bit-equal, at least one sum out and two sums in a MoE
   layer a step, ms a step against the one-process run, peak GB, the
   collectives' ms, bytes and counts a step, the dropped share; (d) where
   two or more cards are visible, the same over a 1x2 layout (32 experts a
   card), its losses within (b)'s rtol of (c)'s; with one card a line
   says that (d) did not run.

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
# phase 22: the LM's distributed pieces, every mesh axis on the one card:
# 21(d)'s first steps under a (2, 2) mesh's rules; phi3's 32 periods as 4
# GPipe stages of 8 over 8 microbatches of 1 x 512 hidden states; the
# compressed all-reduce over 8 stacked data shards
LM_DIST = dict(steps=3, data=2, model=2, stages=4, micro=8, mb_seq=512, shards=8)
# phase 25: the data and pipe axes over ranks: 21(d)'s first steps through
# the data-parallel step, 22(c)'s reduction and 22(b)'s GPipe as one rank's
# block; with two or more cards (b) runs them over 4 ranks (2 with 2 or 3
# cards: 8 shards and 4 stages split evenly), one card each, phi3 at a
# global batch of one sequence a rank
LM_RANKS = dict(steps=3)
# phase 26: the model axis over ranks: 21(d)'s first steps through a 1x1
# (data, model) layout on an NCCL group of one, every model-axis boundary's
# collective issued; with two or more cards (b) a 1x2 layout, one card a
# rank, its bf16 losses within loss_rtol of 21(d)'s (the row-parallel
# contractions add their partial sums in another order)
LM_MODEL_RANKS = dict(loss_rtol=1e-2)
# phase 26(c), (d): the model axis over ranks for MoE layers: deepseek-moe-16b
# at its published widths, its 28 layers cut to 4 so that its train state
# (2.77 B parameters, ~33 GB with the float32 moments) fits beside the run,
# at 21(d)'s batch; (c) a 1x1 layout against its one-process steps, (d) with
# two or more cards a 1x2 layout, 32 experts a card
LM_EXPERT_RANKS = dict(arch="deepseek-moe-16b", layers=4)


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


def in_turns(torch, a, b, reps: int) -> tuple[list[float], list[float]]:
    """`time_ms` of ``a`` and ``b`` in turns, a, b, b, a: two readings of
    each, so that a drift of the card's clocks falls on both."""
    a1, b1, b2, a2 = (time_ms(torch, fn, reps) for fn in (a, b, b, a))
    return [a1, a2], [b1, b2]


def host_enqueue(torch, fn) -> tuple[float, float]:
    """One call of ``fn`` from an idle card: (ms until the host returns,
    ms until the card is done). Near-equal when the host sets the pace."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host * 1e3, (time.perf_counter() - t0) * 1e3


def fmt_ms(values, digits: int) -> str:
    return ", ".join(f"{v:.{digits}f}" for v in values)


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


def resolved(dispatch, sim, batch: int = 1) -> dict[str, str]:
    """The backend of each dispatcher op of a driver's step, as the step
    resolves it (from the memo: the driver resolved its keys at set-up; an
    ensemble bucket's at ``batch`` = its member count)."""
    c = sim.config
    return dispatch.prewarm(dispatch.ops_for_modes(c.deposition, c.gather), device=sim.device, order=c.order,
                            grid_shape=c.grid.shape, capacity=c.capacity, dtype=sim.state.particles.pos.dtype,
                            requested=c.backend, batch=batch)


def kernels_per_replay(torch, graph) -> int:
    """The kernels one replay of a captured step runs (IF bodies that run
    included), counted by the profiler."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset")))


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


def member_axis_kernels(torch, kernels, dep, gat, dev, b: int = 3) -> str:
    """Phase 16(c): each of #1-#5 given ``b`` members at once, one launch,
    bit for bit against ``b`` launches of one member each: at 32^3, orders
    1-3, and at the sweep's member shape 4x4x64, order 1. Returns the
    report; fails on a difference."""
    from repro_torch.core import max_guard, support

    gen = torch.Generator(device=dev).manual_seed(7)
    report = []
    for grid, order, cap in (((32, 32, 32), 1, 16), ((32, 32, 32), 2, 24), ((32, 32, 32), 3, 32),
                             ((4, 4, 64), 1, 16)):
        g, n_cells = max_guard(order), math.prod(grid)
        slabs = [synthetic_slab(torch, grid, cap, gen, dev) for _ in range(b)]
        d, val = (torch.stack([x[k] for x in slabs]) for k in (0, 1))
        padded = torch.randn((b, 6, *(k + 2 * g for k in grid)), generator=gen, device=dev)
        m, n = support(order, True)[0], support(order, False)[0] ** 2
        a, bb, nb = (torch.randn(shape, generator=gen, device=dev)
                     for shape in ((b, n_cells, cap, m), (b, n_cells, cap, n), (b, n_cells, m, n)))
        calls = {
            "fused_bin_deposit": (lambda *x: dep.fused_bin_deposit(*x, order=order), (d, val)),
            "fused_bin_deposit_reduced": (
                lambda *x: dep.fused_bin_deposit_reduced(*x, order=order, grid_shape=grid, guard=g), (d, val)),
            "fused_bin_gather": (lambda *x: gat.fused_bin_gather(*x, grid_shape=grid, order=order, guard=g),
                                 (d, padded)),
            "bin_outer_product": (dep.bin_outer_product, (a, bb)),
            "bin_gather": (gat.bin_gather, (a, bb, nb)),
        }
        row = {}
        for name, (fn, args) in calls.items():
            before = kernels.launch_counts()[name]
            batched = fn(*args)
            launched = kernels.launch_counts()[name] - before
            row[name] = launched == 1 and all(torch.equal(batched[i], fn(*(x[i] for x in args))) for i in range(b))
        report.append(f"{'x'.join(map(str, grid))} order {order} cap {cap}: {row}")
        if not all(row.values()):
            fail(f"ensemble (c): a kernel given {b} members is not one launch bit-equal to a launch a member, at "
                 f"{grid}, order {order}: {row}")
    return "; ".join(report)


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
    from repro_torch.pic.simulation import enter_entry

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
    # the bucket's keys, timed at batch = 2 (phase 4's at 1)
    chosen_b = resolved(dispatch, bucket, batch=bucket.n_members)
    per_bs = {k: (counts.get(k, 0) - bucket.graph_captures) / bucket.bucket_steps for k in FUSED if counts.get(k)}
    equal = [same_state(torch, member_view(bucket, 0), main_final),
             same_state(torch, member_view(bucket, 1), solo_final)]
    say(f"ensemble (a), 2 x uniform {MAIN['grid']}, order {MAIN['order']}: {member_steps} member-steps in "
        f"{bucket.bucket_steps} bucket steps, {ms_ms:.2f} ms/member-step against phase 4's {main['ms_step']:.2f} "
        f"ms/step ({ms_ms / main['ms_step']:.3f}x), set-up {t2 - t1:.2f} s build + "
        f"{bucket.graph_setup_seconds:.2f} s capture, peak {peak:.2f} GB (phase 4: {main['peak_gb']:.2f}), host "
        f"reads {bucket.host_reads} in {bucket.windows} windows ({reads_w:.2f}/window), captures "
        f"{bucket.graph_captures}, resolved at batch 2 {chosen_b} (phase 4: {chosen}), launches {counts} "
        f"({per_bs} per bucket step, the capture's warm-up step aside), bit-equal to the solo runs: {equal} "
        f"(member 0: phase 4's run)")
    if not all(equal) or reads_w != 1.0 or bucket.graph_captures != 1:
        fail("ensemble (a): members not bit-equal to their solo runs, or not one host read a window and one capture")
    # each launch covers both members: one a bucket step (no longer one a
    # member-step)
    if counts != path_launches(chosen_b, bucket.bucket_steps + bucket.graph_captures) or \
            bucket.bucket_steps != int(bucket.host_step.max()):
        fail(f"ensemble (a): the bucket did not launch the resolved kernels {chosen_b} once a bucket step: {counts}")
    del ens, bucket, solo_final
    torch.cuda.empty_cache()

    # (b) the sweep of docs/ensemble.md: two_stream, drift 0.1 / 0.2 / 0.3,
    # four replicas each, as `pic_run --sweep drift=0.1,0.2,0.3 --ensemble 4`
    es = EnsembleSpec.sweep(scenario("two_stream"), parse_sweeps(["drift=0.1,0.2,0.3"]), replicas=4)
    members = es.members()
    solo_s, solo_reads, solo_windows, solos, first = 0.0, 0, 0, [], None
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
        first = sim if first is None else first  # kept for its graph's kernel count below
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
    # the kernels of one replay: a solo member's step, and the bucket's step
    # with every member active (the bucket captured 12 solo steps before it
    # took one over the member axis); these replays move the states on
    solo_buf = first._window.buffers
    solo_buf.reset_counters()
    enter_entry(solo_buf, {4: 1})
    solo_kernels = kernels_per_replay(torch, first._window.graph)
    buf = bucket._window.buffers
    buf.reset_counters()
    enter_entry(buf, {4: [1] * bucket.n_members})
    bucket_kernels = kernels_per_replay(torch, bucket._window.graph)
    say(f"  kernels a replay: {bucket_kernels} for the bucket's step over its {bucket.n_members} members, "
        f"{solo_kernels} for one member's solo step ({bucket.n_members} x {solo_kernels} = "
        f"{bucket.n_members * solo_kernels} in a graph of the members' steps one after another)")
    del ens, bucket, solos, first, buf, solo_buf

    # (c) each of #1-#5 given three members at once
    say("ensemble (c), each kernel given 3 members in one launch, bit-equal to one launch a member: "
        + member_axis_kernels(torch, kernels, dep, gat, dev))

    # (d) growth isolation: tests/test_ensemble.py's members (6^3, order 1,
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
            fail(f"ensemble (d): member {i}'s solo run grew {solo.growths['capacity']} times")
        if i == 0:
            ok = same_state(torch, member_view(ens, 0), solo)
            report.append(f"hot member bit-equal to its solo run (capacity {solo.config.capacity}): {ok}")
            if not ok:
                fail("ensemble (d): the hot member is not bit-equal to its solo run")
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
            fail(f"ensemble (d): sibling {i} is not bit-equal to its solo run: "
                 + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items() if v))
        if (int(ens.sorts[i]), int(ens.rebuilds[i]), ens.member_state(i).step) != \
                (solo.sorts, solo.rebuilds, solo.state.step):
            fail(f"ensemble (d): sibling {i}'s sorts, rebuilds or steps differ from its solo run's")
    say(f"ensemble (d), growth isolation: capacity 12 -> {ens.config.capacity}, growths {ens.growths['capacity']}, "
        f"halts {ens.halts}, captures {ens.graph_captures}, host reads {ens.host_reads} in {ens.windows} windows; "
        + "; ".join(report))
    if ens.growths["capacity"] < 1 or ens.graph_captures != 1 + ens.growths["capacity"]:
        fail("ensemble (d): no growth, or captures other than one plus one a growth")
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
        fail(f"ensemble (d): a kernel regroups its sums with the capacity: {probe}")
    del ens

    # (e) member checkpoints at 32^3
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
        say(f"ensemble (e), member checkpoints at 32^3: save_member(1) at step 8, load_simulation, 4 more steps "
            f"bit-equal to the bucket continuing: {ok_load}; restored into a fresh bucket and run 4 steps, "
            f"bit-equal: {ok_restore}")
        if not (ok_load and ok_restore):
            fail("ensemble (e): a member checkpoint did not continue bit for bit")
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
        fn = small.cache._entries[spec_signature(spec)]
        window = next(iter(fn.store.values()))
        refs = [weakref.ref(fn), weakref.ref(window)] + ([] if window.graph is None else [weakref.ref(window.graph)])
        del window, fn
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


def dist_phase(torch, np, kernels, dispatch, dev, main_final=None) -> dict:
    """Phase 19: the distributed driver on the card (see the module
    docstring). ``main_final``: phase 4's final state, which this phase's
    single-device run must repeat bit for bit. Returns the main cell's
    digests (`dist_digests`) and ms/step, for phase 24."""
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
    kernels.reset_launch_counts()
    dispatch.counters["plain_on_card"] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sim = make_simulation(dist_cell_spec(scenario, sx, sy))
    mig_cap = sim.config.mig_cap
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
    p19 = {"digests": dist_digests(sim), "ms_step": ms_step}  # phase 24 holds the rank path to these
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
    return p19


def dist_cell_spec(scenario, sx: int, sy: int):
    """Phase 19's main cell on an ``sx x sy`` mesh: the migration buffer
    from the face flux (a face's cells, ppc particles a cell, a step moving
    at most 4 (u_thermal + seed amplitude) dt of a cell)."""
    nx_loc, ny_loc = MAIN["grid"][0] // sx, MAIN["grid"][1] // sy
    probe = scenario("uniform", **MAIN)
    flux = probe.plasma.ppc * max(nx_loc, ny_loc) * MAIN["grid"][2] * min(
        1.0, 4 * (probe.plasma.u_thermal + probe.plasma.perturb.amplitude) * probe.dt)
    mig_cap = 1 << math.ceil(math.log2(max(flux, 256)))
    return scenario("uniform", **MAIN, mesh=f"{sx}x{sy}", mig_cap=mig_cap, diagnostics_every=MAIN["window"])


def dist_digests(sim) -> dict:
    """SHA-256 of every tensor of a distributed driver's global view (over
    ranks a collective), of its policy state, and its counters and history
    as JSON: what two runs must share to be bit-equal."""
    import dataclasses
    import hashlib

    sha = lambda t: hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()
    st = sim.global_state()
    out = {k: sha(v) for k, v in st.items() if k != "fields"}
    out.update({f"fields[{i}]": sha(f) for i, f in enumerate(st["fields"])})
    out.update({f"policy.{f.name}": sha(getattr(sim.policy_state, f.name))
                for f in dataclasses.fields(sim.policy_state)})
    out["counters"] = json.dumps([sim.sorts, sim.rebuilds, sim.growths, sim.history, sim.n_local,
                                  sim.config.capacity, sim.config.mig_cap])
    return out


def run_dist_cell(torch, sim) -> dict:
    """Phase 19's schedule: the first window (the capture and its warm-up
    step), then the timed rest. Returns ms/step, captures and host reads a
    window of the timed part."""
    sim.run(MAIN["window"])
    torch.cuda.synchronize()
    reads0, windows0 = sim.host_reads, sim.windows
    t0 = time.perf_counter()
    sim.run(MAIN["steps"] - MAIN["window"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return {"ms_step": 1e3 * dt / (MAIN["steps"] - MAIN["window"]), "captures": sim.graph_captures,
            "reads_w": (sim.host_reads - reads0) / max(sim.windows - windows0, 1)}


def rank_cell(rank: int, world: int, store: str, out: str) -> None:
    """Phase 24(b)'s rank: join the NCCL group of ``world`` ranks, one card
    each, run the main cell on this rank's block, and write (rank 0) the
    digests, the timings and every card's peak memory to ``out``."""
    import torch

    from repro_torch.api import make_simulation, scenario
    from repro_torch.distributed.ranks import close_ranks, init_ranks
    from repro_torch.pic.distributed import make_pic_mesh

    import torch.distributed as dist

    dev = init_ranks(rank, world, store)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats(dev)
        mesh = make_pic_mesh(*DIST_MESH, dist.group.WORLD)
        sim = make_simulation(dist_cell_spec(scenario, *DIST_MESH), mesh=mesh)
        res = run_dist_cell(torch, sim)
        digests = dist_digests(sim)
        peaks = mesh.ranks.values(torch.tensor(torch.cuda.max_memory_allocated(dev) / 1e9, device=dev))
        if rank == 0:
            res.update(digests=digests, peak_gb=[float(v) for v in peaks.cpu()], grid=[mesh.ranks.px, mesh.ranks.py])
            Path(out).write_text(json.dumps(res))
    finally:
        close_ranks()


def ranks_phase(torch, kernels, dispatch, dev, smi: str, p19: dict) -> None:
    """Phase 24: the distributed driver over ranks (see the module
    docstring). ``p19``: phase 19's digests and ms/step."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.api import make_simulation, scenario
    from repro_torch.distributed.ranks import RankGrid, close_ranks, init_ranks
    from repro_torch.pic.distributed import PicMesh, make_pic_mesh

    # (a) one rank: an NCCL group of one, its collectives run for real
    t0 = time.perf_counter()
    store = tempfile.mkdtemp(prefix="chip_smoke_ranks_", dir=ROOT / "build")
    gathers = {"eager": 0, "captured": 0}
    all_gather = dist.all_gather_into_tensor

    def counted(*args, **kw):
        gathers["captured" if torch.cuda.is_current_stream_capturing() else "eager"] += 1
        return all_gather(*args, **kw)

    try:
        init_ranks(0, 1, store)
        if make_pic_mesh(*DIST_MESH, dist.group.WORLD).ranks is not None:
            fail("ranks (a): make_pic_mesh over a group of one is not the one-process stack")
        # a rank grid built on the group of one takes no short-cut: every
        # reduction is an NCCL all-gather, inside the captured window's IF
        # bodies too; the ring shifts stay local rolls (one rank an axis)
        mesh = PicMesh(*DIST_MESH, RankGrid.of_group(*DIST_MESH, dist.group.WORLD))
        spec = dist_cell_spec(scenario, *DIST_MESH)
        kernels.reset_launch_counts()
        dispatch.counters["plain_on_card"] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dist.all_gather_into_tensor = counted
        try:
            sim = make_simulation(spec, mesh=mesh)
            c = sim.config
            chosen = dispatch.prewarm(dispatch.ops_for_modes(c.deposition, c.gather), device=sim.device,
                                      order=c.order, grid_shape=c.local_grid.shape, capacity=c.capacity,
                                      dtype=sim.shard_state.pos.dtype, requested=c.backend)
            res = run_dist_cell(torch, sim)
        finally:
            dist.all_gather_into_tensor = all_gather
        counts = {k: v for k, v in kernels.launch_counts().items() if v and k in FUSED}
        sx, sy = DIST_MESH
        want = {KERNEL_OF[kv]: sx * sy * (MAIN["steps"] + sim.graph_captures) for kv in chosen.items()
                if kv in KERNEL_OF}
        same = dist_digests(sim) == p19["digests"]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        say(f"ranks (a) [{smi}]: NCCL group of 1 rank over a FileStore, a rank grid {mesh.ranks.px}x{mesh.ranks.py} "
            f"built on it, main cell {MAIN['grid']} on {sx}x{sy}: {res['ms_step']:.2f} ms/step (phase 19, no rank "
            f"grid: {p19['ms_step']:.2f}), NCCL all-gathers issued {gathers['eager']} eager and "
            f"{gathers['captured']} into the captured window, captures {res['captures']}, host reads "
            f"{res['reads_w']:.2f} a window, peak {peak_gb:.2f} GB, launches {counts} (want {want}), bit-equal to "
            f"phase 19: {same}")
        if not same or res["captures"] != 1 or res["reads_w"] != 1.0 or not gathers["captured"]:
            fail(f"ranks (a): bit-equal {same}, {res['captures']} captures, {res['reads_w']} reads a window, "
                 f"all-gathers {gathers}")
        if len(chosen) != 2 or any(kv not in KERNEL_OF for kv in chosen.items()) or counts != want:
            fail(f"ranks (a) did not launch the resolved kernels once a shard a step: {counts}, want {want}")
        no_plain(dispatch, "ranks (a)")
        want_digests = dist_digests(sim)
        del sim
        torch.cuda.empty_cache()
    finally:
        close_ranks()
        shutil.rmtree(store, ignore_errors=True)
    say(f"phase 24a: {time.perf_counter() - t0:.1f} s")

    # (b) one card a rank
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        say(f"ranks (b): needs two or more cards, {n_cards} visible: did not run")
        return
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    world = min(n_cards, 4)
    store = tempfile.mkdtemp(prefix="chip_smoke_ranks_", dir=ROOT / "build")
    out = Path(store) / "rank0.json"
    try:
        mp.start_processes(rank_cell, args=(world, store, str(out)), nprocs=world, start_method="spawn")
        got = json.loads(out.read_text())
    finally:
        shutil.rmtree(store, ignore_errors=True)
    same = got["digests"] == want_digests
    say(f"ranks (b) [{smi}]: {world} ranks, one card each (grid {got['grid'][0]}x{got['grid'][1]}, NCCL): "
        f"{got['ms_step']:.2f} ms/step (a: {res['ms_step']:.2f}), captures {got['captures']} a rank, host reads "
        f"{got['reads_w']:.2f} a window, peak GB per card {[round(v, 2) for v in got['peak_gb']]}, bit-equal to "
        f"(a): {same}")
    if not same or got["reads_w"] != 1.0:
        fail(f"ranks (b): bit-equal {same}, {got['reads_w']} reads a window")
    say(f"phase 24b: {time.perf_counter() - t0:.1f} s")


class CollectiveCount:
    """Counts the calls of `torch.distributed`'s collectives the rank path
    issues, while entered (phase 25, as phase 24(a) counts its
    all-gathers)."""

    NAMES = ("all_gather_into_tensor", "all_reduce", "broadcast", "batch_isend_irecv", "barrier")

    def __init__(self, dist):
        self.dist, self.calls, self.saved = dist, {}, {}

    def __enter__(self):
        for name in self.NAMES:
            fn = self.saved[name] = getattr(self.dist, name)

            def counted(*args, _fn=fn, _name=name, **kw):
                self.calls[_name] = self.calls.get(_name, 0) + 1
                return _fn(*args, **kw)

            setattr(self.dist, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.dist, name, fn)


def phi3_ranks_run(torch, dev, data_ranks, batch: int, microbatches: int = 1, cfg=None):
    """Phase 21(d)'s phi3-mini-3.8b (or ``cfg``; bf16, float32 moments,
    seed 0) at a global batch of ``batch`` x 4096, ``LM_RANKS["steps"]``
    steps through the `Supervisor`: over ``data_ranks`` (one shard a rank;
    or a `MeshRanks` layout, whose data axis that is, each rank on its
    blocks of the model axis) the rank's part of the step, else the
    one-process step at ``microbatches``. Returns the losses, ms a step
    (the median after the first), peak GB, the MoE layers' dropped share a
    step (MoE configs), the reduction's ms a step and bytes a rank, over a
    layout the model axis's collectives' ms a step, bytes a step and
    counts a step, and the state."""
    import statistics

    from repro_torch.configs.registry import get_config
    from repro_torch.data import DataConfig, shard_batch_at
    from repro_torch.distributed.fault import Supervisor
    from repro_torch.distributed.ranks import MeshRanks
    from repro_torch.optim import AdamWConfig, ScheduleConfig
    from repro_torch.train import StepClock, TrainConfig, init_train_state, make_train_step

    cfg = cfg or get_config(LM_TRAIN_FULL["arch"])
    n = LM_RANKS["steps"]
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3),
                       schedule=ScheduleConfig(warmup_steps=10, total_steps=LM_TRAIN_FULL["steps"]),
                       microbatches=microbatches)
    data = DataConfig(vocab_size=cfg.vocab_size, global_batch=batch, seq_len=LM_TRAIN_FULL["seq"], seed=0)
    torch.cuda.synchronize(dev)       # the card's context exists before its memory stats are reset
    torch.cuda.reset_peak_memory_stats(dev)
    step = make_train_step(cfg, tcfg, data_ranks)
    state = init_train_state(torch.Generator(device=dev).manual_seed(0), cfg, device=dev, rules=step.rules)
    clock = StepClock(dev)
    timed = clock.wrap(step)
    shards = data_ranks.data if isinstance(data_ranks, MeshRanks) else data_ranks
    r, w = (0, 1) if shards is None else (shards.rank, shards.world)
    sup = Supervisor(lambda st, i: timed(st, shard_batch_at(i, data, r, w, device=dev)), _NoCheckpoint(),
                     async_save=True, ranks=data_ranks)
    state, _ = sup.run(state, n)
    step_ms = clock.ms()
    out = {"losses": [float(m["loss"]) for m in sup.metrics_log], "ms": statistics.median(step_ms[1:]),
           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9, "state": state,
           "dropped": [float(m["moe_dropped_frac"]) for m in sup.metrics_log if "moe_dropped_frac" in m]}
    if data_ranks is not None:
        red = step.reduction.ms()
        out.update(reduce_ms=statistics.median(red[1:]), reduce_bytes=step.reduce_bytes)
    if isinstance(data_ranks, MeshRanks):
        tp = step.rules.model
        tms = tp.step_ms()
        out.update(model_ms=statistics.median(tms[1:]), model_bytes=tp.sent / len(tms),
                   model_counts={k: v / len(tms) for k, v in sorted(tp.counts.items())})
    return out


def lm_rank_cell(rank: int, world: int, store: str, out: str, want: dict) -> None:
    """Phase 25(b)'s rank: join the NCCL group of ``world`` ranks, one card
    each; phi3's data-parallel steps (one sequence a rank), 22(c)'s
    reduction and 22(b)'s GPipe over the ranks, each held bit for bit to
    ``want`` (the stacked runs' SHA-256 digests, taken on one card: the
    parameters after the steps, the reduction's outputs, the pipeline's);
    rank 0 writes the results to ``out``."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.compression import compressed_psum_grads, exact_pmean_grads
    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.distributed.ranks import AxisRanks, close_ranks, init_ranks
    from repro_torch.tree import tree_map

    dev = init_ranks(rank, world, store)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        group = dist.group.WORLD
        cfg = get_config(LM_TRAIN_FULL["arch"])
        got = phi3_ranks_run(torch, dev, AxisRanks.of_group("data", world, group), world)
        res = {k: got[k] for k in ("losses", "ms", "peak_gb", "reduce_ms", "reduce_bytes")}
        res["params"] = tensor_digest(torch, got.pop("state")["params"])
        del got
        torch.cuda.empty_cache()
        data = AxisRanks.of_group("data", LM_DIST["shards"], group)
        g, r = phi3_period_grads(torch, cfg, dev)
        mean, new_r = compressed_psum_grads([data.block(t) for t in g], [data.block(t) for t in r], data)
        exact = exact_pmean_grads([data.block(t) for t in g], data)
        res["reduction"] = tensor_digest(torch, [mean, [data.gather(t) for t in new_r], exact])
        del g, r, mean, new_r, exact
        torch.cuda.empty_cache()
        pipe = AxisRanks.of_group("pipe", LM_DIST["stages"], group)
        params, stages, stage_fn, hidden = phi3_gpipe(torch, cfg, dev)
        with torch.no_grad():
            y = pipeline_forward(tree_map(pipe.block, stages), hidden, stage_fn, mesh={"pipe": LM_DIST["stages"]},
                                 ranks=pipe)
        res["gpipe"] = tensor_digest(torch, y)
        res["peak_gb_all"] = [float(v) for v in
                              data.values(torch.tensor(torch.cuda.max_memory_allocated(dev) / 1e9, device=dev)).cpu()]
        res["same"] = {k: res[k] == want[k] for k in ("params", "reduction", "gpipe")}
        if rank == 0:
            Path(out).write_text(json.dumps(res))
    finally:
        close_ranks()


def tensor_digest(torch, tree) -> str:
    """SHA-256 of the bytes of every leaf of ``tree`` in order."""
    import hashlib

    from repro_torch.tree import tree_leaves

    h = hashlib.sha256()
    for t in tree_leaves(tree):
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def lm_ranks_phase(torch, dispatch, dev, smi: str, full_losses: list[float], full_ms: float) -> None:
    """Phase 25: the LM stack's data and pipe axes over ranks (see the
    module docstring). ``full_losses``, ``full_ms``: phase 21(d)'s."""
    import statistics
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.compression import compressed_psum_grads, exact_pmean_grads
    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.distributed.ranks import AxisRanks, close_ranks, init_ranks

    torch.set_float32_matmul_precision("highest")
    cfg = get_config(LM_TRAIN_FULL["arch"])
    n = LM_RANKS["steps"]

    # (a) one rank: an NCCL group of one, its collectives run for real
    t0 = time.perf_counter()
    store = tempfile.mkdtemp(prefix="chip_smoke_lm_ranks_", dir=ROOT / "build")
    try:
        init_ranks(0, 1, store)
        group = dist.group.WORLD
        data1 = AxisRanks.of_group("data", 1, group)
        with CollectiveCount(dist) as cc:
            got = phi3_ranks_run(torch, dev, data1, LM_TRAIN_FULL["batch"])
        del got["state"]
        torch.cuda.empty_cache()
        want = full_losses[:n]
        say(f"lm ranks (a) [{smi}]: NCCL group of 1 rank over a FileStore; {cfg.name} at full width (bf16, "
            f"{cfg.n_layers} layers, float32 moments), batch {LM_TRAIN_FULL['batch']} x {LM_TRAIN_FULL['seq']} on the "
            f"data axis of 1 rank, {n} steps through the data-parallel step and the Supervisor over the rank: losses "
            + " ".join(f"{x:.4f}" for x in got["losses"]) + f", bit-equal to phase 21(d)'s first {n}: "
            f"{got['losses'] == want}; {got['ms']:.1f} ms/step (median of steps 2-{n}; 21(d): {full_ms:.1f}), peak "
            f"{got['peak_gb']:.2f} GB; gradient reduction {got['reduce_ms']:.2f} ms/step (median of steps 2-{n}), "
            f"{got['reduce_bytes'] / 1e9:.3f} GB a rank; collectives {dict(data1.counts)}, torch.distributed calls "
            f"{cc.calls}")
        if got["losses"] != want:
            fail(f"lm ranks (a): losses {got['losses']!r}, phase 21(d)'s {want!r} (bit-equal)")
        if not cc.calls.get("all_gather_into_tensor") or not data1.counts["reduce_gather"]:
            fail(f"lm ranks (a): the reduction issued no NCCL all-gather ({cc.calls})")

        # 22(c)'s reduction: the 8 shards as the one rank's block
        data8 = AxisRanks.of_group("data", LM_DIST["shards"], group)
        g, r = phi3_period_grads(torch, cfg, dev)
        with CollectiveCount(dist) as cc:
            m_rank, r_rank = compressed_psum_grads(g, r, data8)
            e_rank = exact_pmean_grads(g, data8)
        m_one, r_one = compressed_psum_grads(g, r)
        e_one = exact_pmean_grads(g)
        same = all(torch.equal(a, b) for a, b in zip(m_rank + r_rank + e_rank, m_one + r_one + e_one))
        ms_rank, ms_one = in_turns(torch, lambda: compressed_psum_grads(g, r, data8),
                                   lambda: compressed_psum_grads(g, r), 3)
        say(f"  phase 22(c)'s compressed reduction of one {cfg.name} period ({len(g)} leaves, bf16) over "
            f"{LM_DIST['shards']} shards as one rank's block: mean, residuals and exact mean bit-equal to the stacked "
            f"call: {same}; {fmt_ms(ms_rank, 2)} ms against the stacked {fmt_ms(ms_one, 2)} ms (in turns: rank, "
            f"stacked, stacked, rank); torch.distributed calls {cc.calls} "
            f"(a max gathered and an int32 all-reduce a leaf, a gather a leaf for the exact mean) [{smi}]")
        if not same:
            fail("lm ranks (a): the compressed reduction over the rank is not bit-equal to phase 22(c)'s stacked call")
        del g, r, m_rank, r_rank, e_rank, m_one, r_one, e_one
        torch.cuda.empty_cache()

        # 22(b)'s GPipe: the 4 stages as the one rank's block
        pipe4 = AxisRanks.of_group("pipe", LM_DIST["stages"], group)
        params, stages, stage_fn, hidden = phi3_gpipe(torch, cfg, dev)
        mesh = {"pipe": LM_DIST["stages"]}
        with torch.no_grad():
            with CollectiveCount(dist) as cc:
                y_rank = pipeline_forward(stages, hidden, stage_fn, mesh=mesh, ranks=pipe4)
            y_one = pipeline_forward(stages, hidden, stage_fn, mesh=mesh)
            same = torch.equal(y_rank, y_one)
            # 1 x 512 tokens a stage call: the host's enqueue sets the pace,
            # so three rounds in turns, and one call's enqueue against its
            # wall time for each
            piped = {"rank": lambda: pipeline_forward(stages, hidden, stage_fn, mesh=mesh, ranks=pipe4),
                     "stacked": lambda: pipeline_forward(stages, hidden, stage_fn, mesh=mesh)}
            ms = {"rank": [], "stacked": []}
            for _ in range(3):
                a, b = in_turns(torch, piped["rank"], piped["stacked"], 2)
                ms["rank"] += a
                ms["stacked"] += b
            enqueue = {name: host_enqueue(torch, fn) for name, fn in piped.items()}
        say(f"  phase 22(b)'s GPipe of {cfg.name} as {LM_DIST['stages']} stages, one rank's block, "
            f"{LM_DIST['micro']} microbatches of 1 x {LM_DIST['mb_seq']}: bit-equal to the stacked run: {same}; "
            f"three rounds in turns, rank {fmt_ms(ms['rank'], 1)} ms (median {statistics.median(ms['rank']):.1f}), "
            f"stacked {fmt_ms(ms['stacked'], 1)} ms (median {statistics.median(ms['stacked']):.1f}); one call's host "
            f"enqueue against its wall time: " + ", ".join(f"{k} {h:.1f} of {w:.1f} ms" for k, (h, w) in enqueue.items())
            + f"; torch.distributed calls {cc.calls} (the exchanges have no partner on one rank; the outputs' "
            f"broadcast is real) [{smi}]")
        if not same or not cc.calls.get("broadcast"):
            fail(f"lm ranks (a): GPipe over the rank bit-equal {same}, calls {cc.calls}")
        del params, stages, hidden, y_rank, y_one
        torch.cuda.empty_cache()
    finally:
        close_ranks()
        shutil.rmtree(store, ignore_errors=True)
    no_plain(dispatch, "lm ranks (a)")
    say(f"phase 25a: {time.perf_counter() - t0:.1f} s")

    # (b) one card a rank
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        say(f"lm ranks (b): needs two or more cards, {n_cards} visible: did not run")
        return
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    world = 4 if n_cards >= 4 else 2
    # the stacked runs on this card first: the one-process step at
    # microbatches = world, the reduction and GPipe
    one = phi3_ranks_run(torch, dev, None, world, microbatches=world)
    want = {"params": tensor_digest(torch, one.pop("state")["params"])}
    torch.cuda.empty_cache()
    g, r = phi3_period_grads(torch, cfg, dev)
    m, new_r = compressed_psum_grads(g, r)
    want["reduction"] = tensor_digest(torch, [m, new_r, exact_pmean_grads(g)])
    del g, r, m, new_r
    params, stages, stage_fn, hidden = phi3_gpipe(torch, cfg, dev)
    with torch.no_grad():
        want["gpipe"] = tensor_digest(torch, pipeline_forward(stages, hidden, stage_fn,
                                                              mesh={"pipe": LM_DIST["stages"]}))
    del params, stages, hidden
    torch.cuda.empty_cache()
    store = tempfile.mkdtemp(prefix="chip_smoke_lm_ranks_", dir=ROOT / "build")
    out = Path(store) / "rank0.json"
    try:
        mp.start_processes(lm_rank_cell, args=(world, store, str(out), want), nprocs=world, start_method="spawn")
        got = json.loads(out.read_text())
    finally:
        shutil.rmtree(store, ignore_errors=True)
    say(f"lm ranks (b) [{smi}]: {world} ranks, one card each (NCCL): {cfg.name} data-parallel at one sequence a rank, "
        f"losses " + " ".join(f"{x:.4f}" for x in got["losses"]) + f" (one process at microbatches={world}: "
        + " ".join(f"{x:.4f}" for x in one["losses"]) + f"), {got['ms']:.1f} ms/step against the one process's "
        f"{one['ms']:.1f}, reduction {got['reduce_ms']:.2f} ms/step and {got['reduce_bytes'] / 1e9:.3f} GB a rank, "
        f"peak GB per card {[round(v, 2) for v in got['peak_gb_all']]}; bit-equal to the one-card runs: {got['same']}")
    if not all(got["same"].values()) or got["losses"] != one["losses"]:
        fail(f"lm ranks (b): bit-equal {got['same']}, losses {got['losses']} against {one['losses']}")
    say(f"phase 25b: {time.perf_counter() - t0:.1f} s")


def moe_full_config():
    """Phase 26(c)'s deepseek-moe-16b: its published widths, its depth cut
    to ``LM_EXPERT_RANKS["layers"]``."""
    import dataclasses

    from repro_torch.configs.registry import get_config

    return dataclasses.replace(get_config(LM_EXPERT_RANKS["arch"]), n_layers=LM_EXPERT_RANKS["layers"])


def lm_model_rank_cell(rank: int, world: int, store: str, out: str, moe: bool = False) -> None:
    """Phase 26(b)'s rank (with ``moe``, 26(d)'s): join the NCCL group of
    ``world`` ranks, one card each, as a 1 x ``world`` (data, model)
    layout; phi3's steps (26(c)'s deepseek-moe-16b's) on this rank's
    blocks; rank 0 writes the results to ``out``."""
    import torch

    from repro_torch.distributed.ranks import close_ranks, init_ranks, mesh_ranks

    dev = init_ranks(rank, world, store)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        mesh = mesh_ranks(1, world)
        got = phi3_ranks_run(torch, dev, mesh, LM_TRAIN_FULL["batch"], cfg=moe_full_config() if moe else None)
        res = {k: got[k] for k in ("losses", "ms", "peak_gb", "model_ms", "model_bytes", "dropped")}
        res["peak_gb_all"] = [float(v) for v in
                              mesh.values(torch.tensor(torch.cuda.max_memory_allocated(dev) / 1e9, device=dev)).cpu()]
        if rank == 0:
            Path(out).write_text(json.dumps(res))
    finally:
        close_ranks()


def lm_model_ranks_phase(torch, dispatch, dev, smi: str, full_losses: list[float], full_ms: float,
                         full_peak: float) -> None:
    """Phase 26: the LM stack's model axis over ranks (see the module
    docstring). ``full_losses``, ``full_ms``, ``full_peak``: phase 21(d)'s."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.ranks import close_ranks, init_ranks, mesh_ranks

    torch.set_float32_matmul_precision("highest")
    cfg = get_config(LM_TRAIN_FULL["arch"])
    n = LM_RANKS["steps"]
    want = full_losses[:n]

    # (a) --mesh 1x1 --ranks 1: an NCCL group of one, every model-axis boundary's collective run for real
    t0 = time.perf_counter()
    store = tempfile.mkdtemp(prefix="chip_smoke_lm_model_ranks_", dir=ROOT / "build")
    try:
        init_ranks(0, 1, store)
        mesh = mesh_ranks(1, 1)
        with CollectiveCount(dist) as cc:
            got = phi3_ranks_run(torch, dev, mesh, LM_TRAIN_FULL["batch"])
        del got["state"]
        torch.cuda.empty_cache()
        calls = {k: v / n for k, v in sorted(cc.calls.items())}
        say(f"lm model ranks (a) [{smi}]: NCCL group of 1 rank over a FileStore, a 1x1 (data, model) layout; "
            f"{cfg.name} at full width (bf16, {cfg.n_layers} layers, float32 moments), batch "
            f"{LM_TRAIN_FULL['batch']} x {LM_TRAIN_FULL['seq']}, {n} steps through the tensor- and vocabulary-parallel "
            f"step and the Supervisor over the layout: losses " + " ".join(f"{x:.4f}" for x in got["losses"])
            + f", bit-equal to phase 21(d)'s first {n}: {got['losses'] == want}; {got['ms']:.1f} ms/step (median of "
            f"steps 2-{n}; 21(d): {full_ms:.1f}, {got['ms'] / full_ms - 1:+.2%}), peak {got['peak_gb']:.2f} GB (21(d): "
            f"{full_peak:.2f}); model-axis collectives {got['model_ms']:.2f} ms/step (median of steps 2-{n}, CUDA "
            f"events), {got['model_bytes'] / 1e9:.3f} GB a rank a step, a step: {got['model_counts']}; gradient "
            f"reduction {got['reduce_ms']:.2f} ms/step; torch.distributed calls a step {calls} (eager)")
        if got["losses"] != want:
            fail(f"lm model ranks (a): losses {got['losses']!r}, phase 21(d)'s {want!r} (bit-equal)")
        # every boundary of every layer: a sum after each attention and MLP block and the embedding, and a sum
        # of each column-parallel input's cotangent
        if min(got["model_counts"].get(k, 0) for k in ("sum_out", "copy_in")) < 2 * cfg.n_layers + 1:
            fail(f"lm model ranks (a): the model axis's boundaries issued too few collectives: {got['model_counts']}")
    finally:
        close_ranks()
        shutil.rmtree(store, ignore_errors=True)
    no_plain(dispatch, "lm model ranks (a)")
    say(f"phase 26a: {time.perf_counter() - t0:.1f} s")

    # (b) a 1x2 layout, one card a rank
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        say(f"lm model ranks (b): not run ({n_cards} card)")
        return
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    store = tempfile.mkdtemp(prefix="chip_smoke_lm_model_ranks_", dir=ROOT / "build")
    out = Path(store) / "rank0.json"
    try:
        mp.start_processes(lm_model_rank_cell, args=(2, store, str(out)), nprocs=2, start_method="spawn")
        got = json.loads(out.read_text())
    finally:
        shutil.rmtree(store, ignore_errors=True)
    close = all(abs(a - b) <= LM_MODEL_RANKS["loss_rtol"] * abs(b) for a, b in zip(got["losses"], want))
    say(f"lm model ranks (b) [{smi}]: a 1x2 layout, one card a rank (NCCL): {cfg.name}'s losses "
        + " ".join(f"{x:.4f}" for x in got["losses"]) + f" against 21(d)'s " + " ".join(f"{x:.4f}" for x in want)
        + f" (within rtol {LM_MODEL_RANKS['loss_rtol']}: {close}), {got['ms']:.1f} ms/step against 21(d)'s "
        f"{full_ms:.1f}, model-axis collectives {got['model_ms']:.2f} ms/step and {got['model_bytes'] / 1e9:.3f} GB a "
        f"rank a step, peak GB per card {[round(v, 2) for v in got['peak_gb_all']]}")
    if not close:
        fail(f"lm model ranks (b): losses {got['losses']} against 21(d)'s {want}")
    say(f"phase 26b: {time.perf_counter() - t0:.1f} s")


def lm_expert_ranks_phase(torch, dispatch, dev, smi: str) -> None:
    """Phase 26(c), (d): the model axis over ranks for MoE layers (see the
    module docstring)."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.distributed.ranks import close_ranks, init_ranks, mesh_ranks
    from repro_torch.distributed.sharding import rules_for
    from repro_torch.models import init_params
    from repro_torch.tree import tree_leaves

    torch.set_float32_matmul_precision("highest")
    cfg = moe_full_config()
    n, batch = LM_RANKS["steps"], LM_TRAIN_FULL["batch"]
    n_params = sum(t.numel() for t in tree_leaves(init_params(None, cfg, device="meta")))
    table = rules_for(cfg, mode="train", multi_pod=False, data_axis=1, model_axis=1)

    # (c) the one-process steps, then the same through a 1x1 layout on an NCCL group of one
    t0 = time.perf_counter()
    one = phi3_ranks_run(torch, dev, None, batch, cfg=cfg)
    del one["state"]
    torch.cuda.empty_cache()
    store = tempfile.mkdtemp(prefix="chip_smoke_lm_expert_ranks_", dir=ROOT / "build")
    try:
        init_ranks(0, 1, store)
        mesh = mesh_ranks(1, 1)
        with CollectiveCount(dist) as cc:
            got = phi3_ranks_run(torch, dev, mesh, batch, cfg=cfg)
        del got["state"]
        torch.cuda.empty_cache()
        calls = {k: v / n for k, v in sorted(cc.calls.items())}
        say(f"lm expert ranks (c) [{smi}]: NCCL group of 1 rank over a FileStore, a 1x1 (data, model) layout "
            f"(experts={table['experts']}, expert_mlp={table['expert_mlp']}); {cfg.name} at its published widths "
            f"(d {cfg.d_model}, {cfg.moe.n_experts} experts of {cfg.moe.d_expert}, {cfg.moe.n_shared} shared, top-"
            f"{cfg.moe.top_k}, vocab {cfg.vocab_size}; bf16, float32 moments), depth cut to {cfg.n_layers} of 28 "
            f"layers ({n_params / 1e9:.3f} B parameters), batch {batch} x {LM_TRAIN_FULL['seq']}, {n} steps: losses "
            + " ".join(f"{x:.4f}" for x in got["losses"]) + f", bit-equal to the one-process run's: "
            f"{got['losses'] == one['losses']}; {got['ms']:.1f} ms/step (median of steps 2-{n}; one process "
            f"{one['ms']:.1f}, {got['ms'] / one['ms'] - 1:+.2%}), peak {got['peak_gb']:.2f} GB (one process "
            f"{one['peak_gb']:.2f}); dropped share a step {got['dropped']} (one process {one['dropped']}); "
            f"model-axis collectives {got['model_ms']:.2f} ms/step (median of steps 2-{n}, CUDA events), "
            f"{got['model_bytes'] / 1e9:.3f} GB a rank a step, a step: {got['model_counts']}; gradient reduction "
            f"{got['reduce_ms']:.2f} ms/step; torch.distributed calls a step {calls} (eager)")
        if got["losses"] != one["losses"] or got["dropped"] != one["dropped"]:
            fail(f"lm expert ranks (c): losses {got['losses']!r}, dropped {got['dropped']!r}; one process "
                 f"{one['losses']!r}, {one['dropped']!r} (bit-equal)")
        # a sum out after every attention and MoE block and the embedding; a sum in of every attention's input, every
        # MoE layer's input and gates, and the head's
        counts = got["model_counts"]
        if counts.get("sum_out", 0) < 2 * cfg.n_layers + 1 or counts.get("copy_in", 0) < 3 * cfg.n_layers + 1:
            fail(f"lm expert ranks (c): the MoE layers' boundaries issued too few collectives: {counts}")
    finally:
        close_ranks()
        shutil.rmtree(store, ignore_errors=True)
    no_plain(dispatch, "lm expert ranks (c)")
    say(f"phase 26c: {time.perf_counter() - t0:.1f} s")

    # (d) a 1x2 layout, one card a rank, half the experts a card
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        say(f"lm expert ranks (d): not run ({n_cards} card)")
        return
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    store = tempfile.mkdtemp(prefix="chip_smoke_lm_expert_ranks_", dir=ROOT / "build")
    out = Path(store) / "rank0.json"
    try:
        mp.start_processes(lm_model_rank_cell, args=(2, store, str(out), True), nprocs=2, start_method="spawn")
        two = json.loads(out.read_text())
    finally:
        shutil.rmtree(store, ignore_errors=True)
    close = all(abs(a - b) <= LM_MODEL_RANKS["loss_rtol"] * abs(b) for a, b in zip(two["losses"], got["losses"]))
    say(f"lm expert ranks (d) [{smi}]: a 1x2 layout, one card a rank (NCCL), {cfg.moe.n_experts // 2} experts a "
        f"card: {cfg.name}'s losses " + " ".join(f"{x:.4f}" for x in two["losses"]) + " against (c)'s "
        + " ".join(f"{x:.4f}" for x in got["losses"]) + f" (within rtol {LM_MODEL_RANKS['loss_rtol']}: {close}), "
        f"{two['ms']:.1f} ms/step against (c)'s {got['ms']:.1f}, model-axis collectives {two['model_ms']:.2f} ms/step "
        f"and {two['model_bytes'] / 1e9:.3f} GB a rank a step, peak GB per card "
        f"{[round(v, 2) for v in two['peak_gb_all']]}, dropped share a step {two['dropped']}")
    if not close:
        fail(f"lm expert ranks (d): losses {two['losses']} against (c)'s {got['losses']}")
    say(f"phase 26d: {time.perf_counter() - t0:.1f} s")


def tree_equal(torch, a, b) -> bool:
    """Two dataclass trees of tensors (or None) bit for bit."""
    import dataclasses

    if a is None or b is None:
        return a is b
    return all(torch.equal(getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a))


def pic_state_equal(torch, a, b, pa=None, pb=None) -> bool:
    """Two single-device states (and policy states) bit for bit."""
    return all(tree_equal(torch, getattr(a, part), getattr(b, part))
               for part in ("fields", "particles", "layout", "slab")) and (pa is None or tree_equal(torch, pa, pb))


def functional_phase(torch, np, kernels, dispatch, dev, main, smi: str) -> None:
    """Phase 23: the functional faces on the card (see the module
    docstring)."""
    import dataclasses

    from repro_torch.api import EnsembleSpec, make_ensemble, make_simulation, scenario
    from repro_torch.launch.pic_run import parse_sweeps
    from repro_torch.pic import make_ensemble_window_fn, pic_run_window
    from repro_torch.pic import simulation as tsim
    from repro_torch.pic.dist_simulation import DIAG_NAMES, make_dist_window
    from repro_torch.pic.distributed import make_dist_step
    from repro_torch.pic.simulation import bundle_to_host

    def timed(fn, *, strict: bool):
        """fn() between two synchronizations, under the sync debug mode
        "error" with ``strict`` (any device-to-host read raises)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if strict:
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # (a) pic_run_window at the main cell, 16 steps, twice from one state
    n = MAIN["window"]
    sim = make_simulation(scenario("uniform", **MAIN))
    chosen = resolved(dispatch, sim)
    state0, pstate0, cfg, policy = sim.state, sim.policy_state, sim.config, sim.policy
    store = tsim._PIC_WINDOWS
    builds0, captures0 = store.builds, store.captures
    kernels.reset_launch_counts()
    run = lambda **kw: pic_run_window(state0, pstate0, cfg, n, policy=policy, donate=False, **kw)
    (s1, p1, b1), first_s = timed(run, strict=False)
    first_counts = fused_counts(kernels.launch_counts())
    kernels.reset_launch_counts()
    (s2, p2, b2), second_s = timed(run, strict=True)
    second_counts = fused_counts(kernels.launch_counts())
    captured = store.captures - captures0
    sim.run(n, window=n, diagnostics_every=1)
    h = bundle_to_host(b2)
    rows_equal = (list(h["per_step"]["n_moved"]) == [r["n_moved"] for r in sim.history]
                  and list(h["per_step"]["n_alive"]) == [r["n_alive"] for r in sim.history]
                  and all(h["per_step"][k].tolist() == [float(np.float32(r[k])) for r in sim.history]
                          for k in ("field_energy", "kinetic_energy"))
                  and (int(h["n_sorts"]), int(h["n_rebuilds"])) == (sim.sorts, sim.rebuilds)
                  and bundle_to_host(b1)["per_step"]["n_moved"].tolist() == h["per_step"]["n_moved"].tolist())
    equal = (pic_state_equal(torch, s1, sim.state, p1, sim.policy_state)
             and pic_state_equal(torch, s2, sim.state, p2, sim.policy_state) and int(s2.step) == n)
    target = torch.full((), 5, dtype=torch.int32, device=dev)
    (s5, p5, b5), _ = timed(lambda: run(n_target=target), strict=True)
    five = make_simulation(scenario("uniform", **MAIN))
    five.run(5, window=n)
    equal5 = pic_state_equal(torch, s5, five.state, p5, five.policy_state) and int(s5.step) == 5
    want = path_launches(chosen, n)
    ms = 1e3 * second_s / n
    say(f"functional (a) [{smi}], pic_run_window at the main cell, {n} steps, donate=False, twice from one state: "
        f"{ms:.2f} ms/step on the second call (entry and exit copies included; phase 4: {main['ms_step']:.2f} "
        f"ms/step), first call {first_s:.2f} s with {captured} capture(s) and {store.builds - builds0} build(s); "
        f"launches {first_counts} then {second_counts} (want {want} a call, the capture's warm-up step aside); "
        f"second call under set_sync_debug_mode('error') with no capture; bit-equal to a Simulation window of "
        f"{n} (state, policy state, per-step rows, sorts {sim.sorts}, rebuilds {sim.rebuilds}): "
        f"{equal and rows_equal}; n_target a device tensor of 5: n_done {int(b5['n_done'])}, bit-equal to 5 "
        f"steps: {equal5}")
    if not (equal and rows_equal and equal5) or captured != 1 or second_counts != want \
            or first_counts != path_launches(chosen, n + 1):
        fail("functional (a): pic_run_window not bit-equal to the Simulation window, captured more than once, or "
             "its kernels not launched once a step")
    del sim, five, state0, pstate0, s1, p1, s2, p2, s5, p5
    tsim.clear_windows()
    torch.cuda.empty_cache()

    # (b) the 12 two_stream sweep members stacked, targets 25 and 10
    es = EnsembleSpec.sweep(scenario("two_stream"), parse_sweeps(["drift=0.1,0.2,0.3"]), replicas=4)
    members = es.members()
    bucket = make_ensemble(es).sims[0]
    targets = [25 if i % 2 == 0 else 10 for i in range(bucket.n_members)]
    fns = [make_ensemble_window_fn(), make_ensemble_window_fn()]
    outs, secs = [], []
    for fn in fns:
        (out, sec) = timed(lambda: fn(bucket.state, bucket.policy_state, bucket.config, 25, policy=bucket.policy,
                                      donate=False, n_target=targets), strict=False)
        outs.append(out)
        secs.append(sec)
    (_, _, b_again), again_s = timed(lambda: fns[0](bucket.state, bucket.policy_state, bucket.config, 25,
                                                     policy=bucket.policy, donate=False, n_target=targets),
                                     strict=True)
    hb = bundle_to_host(outs[0][2])
    ok = []
    for i, (m, k) in enumerate(zip(members, targets)):
        solo = make_simulation(m)
        solo.run(k, window=25, diagnostics_every=1)
        view = dataclasses.replace(outs[0][0], **{part: None if getattr(outs[0][0], part) is None else
                                                  tsim._member_tree(getattr(outs[0][0], part), i)
                                                  for part in ("fields", "particles", "layout", "slab")})
        ok.append(pic_state_equal(torch, view, solo.state, tsim._member_tree(outs[0][1], i), solo.policy_state)
                  and hb["per_step"]["n_moved"][i, :k].tolist() == [r["n_moved"] for r in solo.history]
                  and hb["per_step"]["field_energy"][i, :k].tolist() == [float(np.float32(r["field_energy"]))
                                                                         for r in solo.history]
                  and (int(hb["n_sorts"][i]), int(hb["n_rebuilds"][i])) == (solo.sorts, solo.rebuilds)
                  and int(hb["n_done"][i]) == k)
        del solo, view
    same = pic_state_equal(torch, outs[0][0], outs[1][0], outs[0][1], outs[1][1])
    say(f"functional (b) [{smi}], ensemble_run_window over the {bucket.n_members} two_stream sweep members, 25 steps, "
        f"targets 25 and 10: each member bit-equal to its solo run: {ok}; two make_ensemble_window_fn callables, "
        f"captures {[f.captures for f in fns]}, the same bits: {same}; calls {[f'{x:.2f}' for x in secs]} s with "
        f"the capture, {1e3 * again_s:.2f} ms a third call (25 bucket steps, no capture, no host read)")
    if not all(ok) or not same or [f.captures for f in fns] != [1, 1] or fns[0].builds != 1:
        fail("functional (b): a member not bit-equal to its solo run, or a callable captured other than once")
    del bucket, fns, outs, b_again
    torch.cuda.empty_cache()

    # (c) make_dist_window and make_dist_step at the dist main shapes
    sx, sy = DIST_MESH
    nx_loc, ny_loc = MAIN["grid"][0] // sx, MAIN["grid"][1] // sy
    probe = scenario("uniform", **MAIN)
    flux = probe.plasma.ppc * max(nx_loc, ny_loc) * MAIN["grid"][2] * min(
        1.0, 4 * (probe.plasma.u_thermal + probe.plasma.perturb.amplitude) * probe.dt)
    dspec = scenario("uniform", **MAIN, mesh=f"{sx}x{sy}", mig_cap=1 << math.ceil(math.log2(max(flux, 256))),
                     diagnostics_every=n)
    dsim = make_simulation(dspec)
    st = {k: (tuple(f.clone() for f in v) if k == "fields" else v.clone()) for k, v in dsim.state.items()}
    keys = ("fields", "pos", "u", "w", "alive", "slots", "pslot", "slab_d", "slab_valid", "mid_pos", "mid_u")
    win = make_dist_window((sx, sy), dsim.config, dsim.policy, n)
    # the window takes its inputs donated: each call is given copies, made
    # outside the timed span
    copies = lambda: ([tuple(f.clone() for f in st[k]) if k == "fields" else st[k].clone() for k in keys],
                      tsim._clone_tree(dsim.policy_state))
    kernels.reset_launch_counts()
    mine, pmine = copies()
    out, first_s = timed(lambda: win(*mine, pmine, n, 0, 0, 0, 1, None), strict=False)
    kernels.reset_launch_counts()
    mine, pmine = copies()
    out2, second_s = timed(lambda: win(*mine, pmine, n, 0, 0, 0, 1, None), strict=True)
    del mine, pmine
    dcounts = fused_counts(kernels.launch_counts())
    bundles = []
    enter = dsim._enter_window
    dsim._enter_window = lambda *a: bundles.append(enter(*a)) or bundles[-1]
    dsim.run(n, window=n)
    hd = bundle_to_host(out2[-1])

    def state_equal(got, want) -> bool:
        return all((all(torch.equal(a, b) for a, b in zip(g, want[k])) if k == "fields" else torch.equal(g, want[k]))
                   for k, g in zip(keys, got))

    dequal = (state_equal(out[:11], dsim.state) and state_equal(out2[:11], dsim.state)
              and all(np.array_equal(hd["per_step"][k], bundles[0]["per_step"][k]) for k in DIAG_NAMES)
              and (int(hd["n_sorts"]), int(hd["n_rebuilds"])) == (dsim.sorts, dsim.rebuilds))
    c = dsim.config
    dchosen = dispatch.prewarm(dispatch.ops_for_modes(c.deposition, c.gather), device=dev, order=c.order,
                               grid_shape=c.local_grid.shape, capacity=c.capacity, dtype=st["pos"].dtype,
                               requested=c.backend)
    dwant = path_launches(dchosen, sx * sy * n)
    del dsim, out, out2
    torch.cuda.empty_cache()
    host = make_simulation(dspec)
    st = {k: (tuple(f.clone() for f in v) if k == "fields" else v.clone()) for k, v in host.state.items()}
    step = make_dist_step((sx, sy), host.config)
    cur = tuple(st[k] for k in keys[:9])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(4):
        *cur, _stats = step(*cur)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / 4
    host.run(4, window=None)
    sequal = state_equal(cur, host.state)
    say(f"functional (c) [{smi}], make_dist_window at the main cell on {sx}x{sy}, {n} steps: "
        f"{1e3 * second_s / n:.2f} ms/step on the second call (under set_sync_debug_mode('error'), no capture; "
        f"first call {first_s:.2f} s with the capture), launches {dcounts} (want {dwant}), bit-equal to the "
        f"DistSimulation window (state, per-step rows, sorts): {dequal}; make_dist_step, 4 eager steps at "
        f"{step_ms:.2f} ms/step, bit-equal to DistSimulation.run(4, window=None): {sequal}")
    if not (dequal and sequal) or win.captures != 1 or dcounts != dwant:
        fail("functional (c): the distributed builders are not bit-equal to the driver, or the window captured "
             "more than once, or its kernels did not launch once a shard a step")
    del host, cur, st, win
    torch.cuda.empty_cache()


def lm_phase(torch, dev, smi: str) -> None:
    """Phase 20: the language-model stack on the card (see the module
    docstring). ``smi``: the card's name and power limit, printed beside
    every number."""
    import dataclasses

    from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
    from repro_torch.launch.serve import generate, make_inputs
    from repro_torch.models import decode_step, encode, forward, init_decode_state, init_params
    from repro_torch.models import moe as lm_moe
    from repro_torch.tree import tree_map

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


def train_phase(torch, np, dispatch, dev, smi: str) -> tuple[list[float], float, float]:
    """Phase 21: LM training on the card (see the module docstring).
    Returns (d)'s losses, its ms a step and its peak GB."""
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
    return losses, ms, peak


def phi3_gpipe(torch, cfg, dev):
    """Phases 22(b) and 25: phi3's parameters from seed 0, its periods as
    ``LM_DIST["stages"]`` stacked stages (views of the layer stack), the
    stage function (the model's own block over the stage's periods) and
    the microbatches of hidden states from seed 22."""
    from repro_torch.models.transformer import _block_apply, init_params
    from repro_torch.tree import tree_leaves, tree_map

    n_st, n_mb, mb_seq = LM_DIST["stages"], LM_DIST["micro"], LM_DIST["mb_seq"]
    per = cfg.n_periods // n_st
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    layers = params["layers"][0]            # phi3's pattern is one block: a period is a layer
    stages = tree_map(lambda a: a.view(n_st, per, *a.shape[1:]), layers)
    if any(a.data_ptr() != b.data_ptr() for a, b in zip(tree_leaves(stages), tree_leaves(layers))):
        fail("the GPipe stages are not views of the layer stack")
    spec = cfg.pattern[0]
    pos = torch.arange(mb_seq, dtype=torch.int32, device=dev)

    def stage_fn(p, x):
        for i in range(per):
            x, _, _ = _block_apply(tree_map(lambda a: a[i], p), x, spec, cfg, positions=pos, cache=None,
                                   cache_index=None, causal=True, enc_out=None)
        return x

    gen = torch.Generator(device=dev).manual_seed(22)
    hidden = torch.randn((n_mb, 1, mb_seq, cfg.d_model), generator=gen, device=dev).to(cfg.dtype)
    return params, stages, stage_fn, hidden


def phi3_period_grads(torch, cfg, dev):
    """Phases 22(c) and 25: one phi3 period's gradient leaves in bf16 over
    ``LM_DIST["shards"]`` stacked shards and float32 residuals, from seed
    23."""
    from repro_torch.models.transformer import init_params
    from repro_torch.tree import tree_leaves

    shards = LM_DIST["shards"]
    shapes = [a.shape[1:] for a in tree_leaves(init_params(None, cfg, device="meta")["layers"])]
    gen = torch.Generator(device=dev).manual_seed(23)
    g = [(torch.randn((shards, *sh), generator=gen, device=dev) * 1e-3).to(cfg.dtype) for sh in shapes]
    r = [torch.randn((shards, *sh), generator=gen, device=dev) * 1e-6 for sh in shapes]
    return g, r


def lm_dist_phase(torch, np, dispatch, dev, smi: str, full_losses: list[float]) -> None:
    """Phase 22: the LM's distributed pieces on the card (see the module
    docstring). ``full_losses``: phase 21(d)'s."""
    import importlib.util
    import statistics

    from repro_torch.configs.registry import get_config
    from repro_torch.data import DataConfig, global_batch_at
    from repro_torch.distributed import Rules, Supervisor, use_rules
    from repro_torch.distributed.compression import compressed_psum_grads, exact_pmean_grads
    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.distributed.sharding import rules_for
    from repro_torch.launch.train import StepClock
    from repro_torch.models.common import embed_lookup
    from repro_torch.optim import AdamWConfig, ScheduleConfig
    from repro_torch.train import TrainConfig, init_train_state, make_train_step
    from repro_torch.tree import tree_map

    torch.set_float32_matmul_precision("highest")
    spec_ex = importlib.util.spec_from_file_location("torch_dist_lm", ROOT / "examples" / "torch_dist_lm.py")
    ex = importlib.util.module_from_spec(spec_ex)
    spec_ex.loader.exec_module(ex)

    # (a) 21(d)'s initial state and batches under a (data, model) mesh's rules
    t0 = time.perf_counter()
    cfg = get_config(LM_TRAIN_FULL["arch"])
    bsz, seq, n = LM_TRAIN_FULL["batch"], LM_TRAIN_FULL["seq"], LM_TRAIN_FULL["steps"]
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3), schedule=ScheduleConfig(warmup_steps=10, total_steps=n))
    data = DataConfig(vocab_size=cfg.vocab_size, global_batch=bsz, seq_len=seq, seed=0)
    mesh = {"data": LM_DIST["data"], "model": LM_DIST["model"]}
    rules = Rules(rules_for(cfg, mode="train", multi_pod=False, data_axis=mesh["data"], model_axis=mesh["model"]),
                  mesh)
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    clock = StepClock(dev)
    train_step = clock.wrap(make_train_step(cfg, tcfg))
    sup = Supervisor(lambda st, i: train_step(st, global_batch_at(i, data, device=dev)), _NoCheckpoint(),
                     async_save=True)
    # phi3 is dense: the embedding backward's pre-sort is the step's only
    # argsort, so counting argsort's calls shows which branch ran
    argsort, sorts = torch.argsort, [0]

    def counted_argsort(*a, **k):
        sorts[0] += 1
        return argsort(*a, **k)

    torch.argsort = counted_argsort
    try:
        with use_rules(rules):
            sup.run(state, LM_DIST["steps"])
    finally:
        torch.argsort = argsort
    step_ms = clock.ms()
    losses = [float(m["loss"]) for m in sup.metrics_log]
    want = full_losses[:LM_DIST["steps"]]
    if losses != want:
        fail(f"{cfg.name} under the rules of mesh {mesh}: losses {losses!r}, phase 21(d)'s {want!r} (bit-equal)")
    if sorts[0] != 0:
        fail(f"{cfg.name} under the rules of mesh {mesh}: {sorts[0]} argsort calls in {LM_DIST['steps']} steps "
             "(the embedding backward must skip its pre-sort under rules)")
    # the same branch alone at the main path's shapes, against the pre-sort
    table = state["params"]["embed"]["table"].detach().requires_grad_(True)
    ids = global_batch_at(0, data, device=dev)["inputs"]
    cot = torch.randn((bsz, seq, cfg.d_model), generator=torch.Generator(device=dev).manual_seed(7),
                      device=dev).to(table.dtype)
    grads, counts = [], []
    torch.argsort = counted_argsort
    try:
        for r in (None, rules):
            sorts[0] = 0
            with use_rules(r):
                y = embed_lookup(table, ids)
            grads.append(torch.autograd.grad(y, table, cot)[0])
            counts.append(sorts[0])
    finally:
        torch.argsort = argsort
    if counts != [1, 0] or not torch.equal(*grads):
        fail(f"embedding backward at {tuple(ids.shape)} ids into {tuple(table.shape)}: argsort calls "
             f"{counts} (want [1, 0] without and with rules), bit-equal {torch.equal(*grads)}")
    del table, grads, cot
    say(f"  {cfg.name} at full width under mesh {mesh}'s rules ("
        + ", ".join(f"{k}={v}" for k, v in rules.table.items() if v is not None)
        + f"), {LM_DIST['steps']} steps through the Supervisor: losses " + " ".join(f"{x:.4f}" for x in losses)
        + f", bit-equal to phase 21(d)'s first {LM_DIST['steps']}, no argsort in them (the embedding backward "
        "unsorted under rules; alone at these shapes its gradient is bit-equal to the pre-sorted one's); "
        f"{statistics.median(step_ms[1:]):.1f} ms/step (median of steps 2-{LM_DIST['steps']}; first "
        f"{step_ms[0]:.1f}), peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{smi}]")
    del state, sup
    torch.cuda.empty_cache()
    say(f"phase 22a: {time.perf_counter() - t0:.1f} s")

    # (b) GPipe: phi3's periods as stacked stages, on views of the layer stack
    t0 = time.perf_counter()
    n_st, n_mb, mb_seq = LM_DIST["stages"], LM_DIST["micro"], LM_DIST["mb_seq"]
    per = cfg.n_periods // n_st
    params, stages, stage_fn, hidden = phi3_gpipe(torch, cfg, dev)

    def piped():
        return pipeline_forward(stages, hidden, stage_fn, mesh={"pipe": n_st})

    def sequential():
        outs = []
        for m in range(n_mb):
            x = hidden[m]
            for s in range(n_st):
                x = stage_fn(tree_map(lambda a, s=s: a[s], stages), x)
            outs.append(x)
        return torch.stack(outs)

    with torch.no_grad():
        got, ref = piped(), sequential()
        if not bool(torch.isfinite(got.float()).all()):
            fail(f"GPipe over {cfg.name}'s stages: output not finite")
        if not torch.equal(got, ref):
            diff = (got.float() - ref.float()).abs()
            fail(f"GPipe over {cfg.name}'s stages is not bit-equal to the sequential composition: "
                 f"{int((diff > 0).sum())} elements differ, max |diff| {float(diff.max()):.3e}")
        ms_pipe, ms_seq = time_ms(torch, piped, 2), time_ms(torch, sequential, 2)
    calls = n_st * (n_mb + n_st - 1) * per
    say(f"  GPipe over {cfg.name}'s {cfg.n_periods} periods as {n_st} stages of {per} (views of the layer stack), "
        f"{n_mb} microbatches of 1 x {mb_seq} hidden states, bf16, no grad: bit-equal to the sequential composition; "
        f"{ms_pipe:.1f} ms against {ms_seq:.1f} ms, ratio {ms_pipe / ms_seq:.3f} (the schedule's "
        f"{calls}/{n_st * n_mb * per} = {calls / (n_st * n_mb * per):.3f} layer calls) [{smi}]")
    del params, stages, hidden, got, ref
    torch.cuda.empty_cache()
    w, x = (torch.from_numpy(a).to(dev) for a in ex.pipeline_inputs())
    got, ref = ex.pipeline_check(w, x)
    err = float((got - ref).abs().max())
    if err > 1e-5:
        fail(f"GPipe at check B's shapes: {err:.3e} off the sequential composition (tolerance 1e-5)")
    say(f"  GPipe at check B's shapes ({ex.STAGES} stages, {ex.MICRO} microbatches of {ex.MB} x {ex.D}, "
        f"tanh(x @ w)): within {err:.2e} of the sequential composition (tolerance 1e-5)")
    say(f"phase 22b: {time.perf_counter() - t0:.1f} s")

    # (c) the compressed all-reduce: check C on the card and on the CPU
    t0 = time.perf_counter()
    card = {c: ex.dp_run(c, dev) for c in (False, True)}
    cpu = {c: ex.dp_run(c, "cpu") for c in (False, True)}
    if not ex.dp_criteria(card[False], card[True]):
        fail(f"check C on the card: compressed losses {card[True][0]:.4f} -> {card[True][-1]:.4f}, exact "
             f"{card[False][-1]:.4f} (last below 0.2 of the first and below 1.5 x exact + 1e-3)")
    rel = max(abs(a - b) / abs(b) for c in (False, True) for a, b in zip(card[c], cpu[c]))
    say(f"  check C ({ex.SHARDS} stacked data shards, {ex.STEPS} steps, a {ex.D}x{ex.D} linear model, AdamW lr "
        f"{ex.DP_OPT.lr}): compressed {card[True][0]:.4f} -> {card[True][-1]:.4f}, exact {card[False][-1]:.4f} "
        f"(criteria met); card against CPU, largest relative loss difference {rel:.2e} [{smi}]")
    for c, name in ((True, "compressed"), (False, "exact")):
        say(f"    {name} losses, card: " + " ".join(f"{v:.6g}" for v in card[c]))
        say(f"    {name} losses, cpu:  " + " ".join(f"{v:.6g}" for v in cpu[c]))
    # one reduction from the same stacked grads and residuals, card and CPU
    rng = np.random.default_rng(22)
    for dt in (torch.float32, torch.bfloat16):
        g = {"w": torch.from_numpy(rng.normal(size=(ex.SHARDS, 1000, 1001)).astype(np.float32)).to(dt),
             "b": torch.from_numpy(rng.normal(size=(ex.SHARDS, 77)).astype(np.float32) * 1e-3).to(dt)}
        r = {k: torch.from_numpy(rng.normal(size=v.shape).astype(np.float32) * 1e-2) for k, v in g.items()}
        m_cpu, r_cpu = compressed_psum_grads(g, r)
        m_card, r_card = compressed_psum_grads({k: v.to(dev) for k, v in g.items()},
                                               {k: v.to(dev) for k, v in r.items()})
        e_cpu, e_card = exact_pmean_grads(g), exact_pmean_grads({k: v.to(dev) for k, v in g.items()})
        for k in g:
            for name, a, b in (("compressed mean", m_card[k], m_cpu[k]), ("residuals", r_card[k], r_cpu[k]),
                               ("exact mean", e_card[k], e_cpu[k])):
                if not torch.equal(a.cpu(), b):
                    fail(f"one {dt} reduction, leaf {k}: the card's {name} is not bit-equal to the CPU's "
                         f"({int((a.cpu() != b).sum())} elements differ)")
    say(f"  one reduction of {ex.SHARDS} stacked shards (8 x 1000 x 1001 and 8 x 77, float32 and bfloat16 grads, "
        f"float32 residuals): compressed mean, residuals and exact mean bit-equal card against CPU")

    # one phi3 period's gradient leaves in bf16 over 8 shards, float32 residuals
    shards = LM_DIST["shards"]
    g, r = phi3_period_grads(torch, cfg, dev)
    numel = sum(t[0].numel() for t in g)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms_comp = time_ms(torch, lambda: compressed_psum_grads(g, r), 3)
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    ms_exact = time_ms(torch, lambda: exact_pmean_grads(g), 3)
    # the identity on the float32 values: a float32 copy of g quantizes to
    # the same q (g32 = g.float() + r) and keeps the mean uncast
    worst = 0.0
    for gi, ri in zip(g, r):
        g32 = gi.float()
        (mean32,), (new_r,) = compressed_psum_grads([g32], [ri])
        g32 += ri
        lhs = shards * mean32.double() + new_r.double().sum(0)
        rhs = g32.double().sum(0)
        tol = 2.0 ** -22 * (g32.double().abs().sum(0) + shards * mean32.double().abs())
        worst = max(worst, float(((lhs - rhs).abs() / tol.clamp_min(1e-300)).max()))
        del g32, mean32, new_r, lhs, rhs, tol
    if worst > 1.0:
        fail(f"the error-feedback identity n * mean + sum(new_r) = sum(g + r) is off by {worst:.2f} x its "
             f"tolerance (4 float32 roundings of sum|g + r| + n|mean|)")
    say(f"  compressed all-reduce of one {cfg.name} period's gradients ({len(g)} leaves, {numel / 1e6:.1f} M "
        f"parameters, bf16) over {shards} stacked shards, float32 residuals ({shards * numel * 2 / 1e9:.2f} GB of "
        f"gradients, {shards * numel * 4 / 1e9:.2f} GB of residuals): {ms_comp:.2f} ms against the exact mean's "
        f"{ms_exact:.2f} ms, {peak:.2f} GB of temporaries; int8 payload {shards * numel / 1e9:.2f} GB against "
        f"{shards * numel * 4 / 1e9:.2f} GB in float32; n * mean + sum(new_r) = sum(g + r) within "
        f"{worst:.3f} of its tolerance (4 float32 roundings of sum|g + r| + n|mean|) [{smi}]")
    del g, r
    torch.cuda.empty_cache()
    say(f"phase 22c: {time.perf_counter() - t0:.1f} s")
    no_plain(dispatch, "the LM's distributed pieces")


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
    p19 = dist_phase(torch, np, kernels, dispatch, dev, main_final)
    del main_final
    say(f"phase 19: {time.perf_counter() - t0:.1f} s")

    # -- 20. the language-model stack on the card ---------------------------------------------
    t0 = time.perf_counter()
    lm_phase(torch, dev, smi)
    say(f"phase 20: {time.perf_counter() - t0:.1f} s")

    # -- 21. language-model training on the card ---------------------------------------------
    t0 = time.perf_counter()
    full_losses, full_ms, full_peak = train_phase(torch, np, dispatch, dev, smi)
    say(f"phase 21: {time.perf_counter() - t0:.1f} s")

    # -- 22. the LM's distributed pieces on the card --------------------------------------------
    t0 = time.perf_counter()
    lm_dist_phase(torch, np, dispatch, dev, smi, full_losses)
    say(f"phase 22: {time.perf_counter() - t0:.1f} s")

    # -- 23. the functional faces on the card ------------------------------------------------
    t0 = time.perf_counter()
    dispatch.counters["plain_on_card"] = 0
    functional_phase(torch, np, kernels, dispatch, dev, main, smi)
    no_plain(dispatch, "the functional faces")
    say(f"phase 23: {time.perf_counter() - t0:.1f} s")

    # -- 24. the distributed driver over ranks --------------------------------------------------
    t0 = time.perf_counter()
    ranks_phase(torch, kernels, dispatch, dev, smi, p19)
    say(f"phase 24: {time.perf_counter() - t0:.1f} s")

    # -- 25. the LM stack's data and pipe axes over ranks ----------------------------------------
    t0 = time.perf_counter()
    lm_ranks_phase(torch, dispatch, dev, smi, full_losses, full_ms)
    say(f"phase 25: {time.perf_counter() - t0:.1f} s")

    # -- 26. the LM stack's model axis over ranks ---------------------------------------------------
    t0 = time.perf_counter()
    lm_model_ranks_phase(torch, dispatch, dev, smi, full_losses, full_ms, full_peak)
    lm_expert_ranks_phase(torch, dispatch, dev, smi)
    say(f"phase 26: {time.perf_counter() - t0:.1f} s")
    AUTOTUNE_CACHE.unlink(missing_ok=True)

    say(f"total {time.perf_counter() - t_start:.1f} s")
    order_of = ("fused_bin_deposit", "fused_bin_deposit_reduced", "fused_bin_gather", "bin_outer_product",
                "bin_gather", "segment_accumulate")
    say(json.dumps({"kernels": [results[k] for k in order_of]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
