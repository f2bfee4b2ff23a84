"""The LM stack's model axis over ranks for MoE layers, one process a rank
(gloo on the CPU): expert parallelism where the model ranks divide the
expert count, tensor parallelism inside each expert where they do not,
against the one-process step and against the reference.

One module-scoped fixture writes the inputs (each config's whole initial
train state and its batches), starts the 4 ranks of
tests/lm_expert_ranks_check.py joined through a ``FileStore`` in a
temporary directory, and meanwhile runs in this process the one-process
port steps, the reference's single-device steps and the launcher's
one-process runs; it waits for every rank under one join timeout.

- (i) 3 steps of ``tiny_moe`` (check A's model, 4 experts) over 1x2 and
  2x2, of deepseek-moe-16b's smoke config (8 experts, 2 shared) over 1x2,
  2x2 and 1x3 (each expert's width 48 over 3, the shared width 96 over 3)
  and of mixtral-8x22b's (4 experts, 8 heads) over 1x2 and 1x3 (8 heads
  unevenly over 3): every metric within rtol 1e-5 of the one-process step
  at ``microbatches = D`` (``moe_load_balance`` and ``moe_dropped_frac``
  included), ``tokens`` and ``accuracy`` exact, the gathered parameters
  and moments within check A's rtol 2e-3 and atol 2e-5, both data rows of
  2x2 bit-equal, every model rank's replicated leaves (the router's among
  them) bit-equal;
- (ii) ``tiny_moe`` and deepseek over each of their meshes against the
  reference's single-device steps at ``microbatches = D`` (check A's
  tolerances: each loss rtol 1e-4, the parameters after 3 steps rtol
  2e-3, atol 2e-5);
- (iii) deepseek over a 2x1 layout (the experts over model groups of one)
  bit-equal to the data-parallel step on the same 2 ranks, and deepseek and
  mixtral over a 1x1 layout bit-equal to the process without ranks;
- (iv) deepseek's 1x2 checkpoint (experts over the ranks) restored in one
  process, bit-equal to the gathered tree;
- (v) ``launch.train`` over 1x2 for deepseek and mixtral, within rtol 1e-5
  of its one-process runs;
- (vi) a rank's blocks of the MoE leaves and its slots, without a spawn.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import lm_expert_ranks_check as check  # noqa: E402
import repro.configs.registry as rreg  # noqa: E402
import repro.train as rtrain  # noqa: E402
from repro.models import LayerSpec as RLayerSpec, ModelConfig as RModelConfig, MoEConfig as RMoEConfig  # noqa: E402
from repro.optim import AdamWConfig, ScheduleConfig  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.distributed.sharding import Rules, rules_for  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import init_params, params_to_numpy  # noqa: E402
from repro_torch.models.moe import _local_slots  # noqa: E402
from repro_torch.train import init_train_state  # noqa: E402
from repro_torch.train.step import param_blocks  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
JOIN_TIMEOUT_S = 120.0
METRIC_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 2e-3, 2e-5     # check A (tests/dist_lm_check.py)
LOSS_RTOL = 1e-4                        # check A
EXACT = ("tokens", "accuracy")
CASES = [(arch, mesh) for arch, meshes in check.CASES.items() for mesh in meshes]
REF_CASES = [(arch, mesh) for arch, mesh in CASES if arch in check.REF_ARCHS]


def _data_axis(mesh: str) -> int:
    return check.MESHES[mesh][0]


def reference_config(arch: str):
    """The reference's counterpart of `check.config`."""
    if arch == "tiny_moe":
        return RModelConfig(name="tiny_moe", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=64,
                            pattern=(RLayerSpec("attn", "moe"),),
                            moe=RMoEConfig(n_experts=4, top_k=2, capacity_factor=4.0))
    return rreg.get_smoke_config(arch)


def reference_steps(arch: str, inputs: dict, microbatches: int):
    """The reference's single-device steps of ``arch``'s config from the
    same state and batches: (each step's metrics, the parameters after the
    last) as numpy."""
    tcfg = rtrain.TrainConfig(optimizer=AdamWConfig(lr=1e-3), schedule=ScheduleConfig(warmup_steps=2, total_steps=50),
                              microbatches=microbatches)
    state = jax.tree.map(jnp.asarray, params_to_numpy(inputs["state"]))
    step = jax.jit(rtrain.make_train_step(reference_config(arch), tcfg))
    metrics = []
    for b in inputs["batches"][:check.STEPS]:
        state, m = step(state, {k: jnp.asarray(v.numpy()) for k, v in b.items()})
        metrics.append(jax.tree.map(np.asarray, m))
    return metrics, jax.tree.map(np.asarray, state["params"])


def _one_process(inputs: dict, tmp: Path) -> dict:
    """The one-process runs: each config at ``microbatches`` = each data
    axis it runs over, the reference's steps, the launcher's runs."""
    one = {}
    for arch, mesh in CASES:
        key = f"{arch}.{_data_axis(mesh)}"
        if key not in one:
            one[key] = check.train(arch, inputs[arch], None, _data_axis(mesh))[:2]
    for arch, mesh in REF_CASES:
        key = f"reference.{arch}.{_data_axis(mesh)}"
        if key not in one:
            one[key] = reference_steps(arch, inputs[arch], _data_axis(mesh))
    for arch in check.LAUNCH:
        args = launch_train.parser().parse_args(check.launch_argv(arch) + ["--ckpt-dir", str(tmp / f"ckpt.one.{arch}")])
        one[f"launch.{arch}"] = launch_train.train(args, device=torch.device("cpu"), out=lambda *a: None)
    return one


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results and the one process's, from one spawn."""
    tmp = tmp_path_factory.mktemp("lm_expert_ranks")
    inputs = {arch: check.make_inputs(arch) for arch in check.CASES}
    torch.save(inputs, tmp / "inputs.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), str(REPO / "tests"), os.environ.get("PYTHONPATH", "")]))
    (tmp / "store").mkdir()
    procs, logs = [], []
    try:
        for r in range(check.WORLD):
            logs.append(open(tmp / f"rank{r}.log", "w"))
            procs.append(subprocess.Popen([sys.executable, str(REPO / "tests" / "lm_expert_ranks_check.py"), str(r),
                                           str(check.WORLD), str(tmp / "store"), str(tmp), str(tmp / "inputs.pt")],
                                          env=env, stdout=logs[-1], stderr=subprocess.STDOUT, cwd=str(tmp)))
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            one = _one_process(inputs, tmp)
        finally:
            torch.set_num_threads(n)
        for r, proc in enumerate(procs):
            try:
                rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc != 0:
                tails = {i: (tmp / f"rank{i}.log").read_text()[-3000:] for i in range(check.WORLD)}
                pytest.fail(f"rank {r}: {rc} (join timeout {JOIN_TIMEOUT_S} s); logs: {tails}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for log in logs:
            log.close()
    yield {"dir": tmp, "one": one, "inputs": inputs}


def _load(runs, name: str):
    return torch.load(runs["dir"] / f"{name}.pt", weights_only=True)


def _equal_trees(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _close_trees(got, want, what: str) -> None:
    for i, (a, b) in enumerate(zip(tree_leaves(got), tree_leaves(want), strict=True)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=f"{what} {i}")


# -- (i), (ii): the step over the model ranks ---------------------------------------------------


@pytest.mark.parametrize("arch,mesh", CASES)
def test_expert_axis_step_matches_one_process(runs, arch, mesh):
    d, m = check.MESHES[mesh][:2]
    got = _load(runs, f"train.{arch}.{mesh}.row0")
    state, metrics = runs["one"][f"{arch}.{d}"]
    assert len(got["metrics"]) == len(metrics) == check.STEPS
    for i, (g, w) in enumerate(zip(got["metrics"], metrics)):
        assert g.keys() == w.keys() and "moe_load_balance" in w and "moe_dropped_frac" in w
        for k in w:
            a, b = float(g[k]), float(w[k])
            if k in EXACT:
                assert a == b, (arch, mesh, i, k, a, b)
            else:
                assert abs(a - b) <= METRIC_RTOL * max(abs(b), 1e-6), (arch, mesh, i, k, a, b)
    assert int(got["state"]["step"]) == check.STEPS
    _close_trees(got["state"]["params"], state["params"], f"{arch} over {mesh}")
    _close_trees(got["state"]["opt"], state["opt"], f"{arch}'s moments over {mesh}")
    for r in range(1, d):  # every data row holds the same replica
        assert _equal_trees(_load(runs, f"train.{arch}.{mesh}.row{r}")["state"], got["state"]), (arch, mesh, r)
    # the router's gradient is whole on every model rank, so every replicated leaf stays the same bits
    rep = [_load(runs, f"replicated.{arch}.{mesh}.m{r}") for r in range(m)]
    assert all(_equal_trees(rep[0], other) for other in rep[1:]), (arch, mesh)
    # each step crossed every layer's boundaries: a sum after each attention and MoE block (under the sequence
    # split a reduce-scatter onto the rank's block, whose backward gathers the cotangent once a boundary a step),
    # and once a boundary a step the sums in of the attention's input, the experts' input and the head's (the
    # backward of the sequence's all-gather) and of the combine's gates: 3L+1 sums in, as without the split
    cfg = check.config(arch)
    n, n_layers = check.STEPS, cfg.total_layers
    n_moe = sum(1 for s in cfg.pattern if s.ffn == "moe") * cfg.n_periods + sum(1 for s in cfg.tail if s.ffn == "moe")
    counts = got["counts"]
    assert counts["seq_scatter"] >= n * 2 * n_layers and counts["seq_scatter_grad"] >= n * 2 * n_layers
    assert counts["seq_gather_grad"] >= n * (2 * n_layers + 1)
    assert counts["copy_in"] >= n * n_moe and counts["seq_gather_grad"] + counts["copy_in"] >= n * (3 * n_layers + 1)
    assert counts["norm"] == check.STEPS


@pytest.mark.parametrize("arch,mesh", REF_CASES)
def test_over_expert_ranks_matches_the_reference(runs, arch, mesh):
    """Check A's tolerances (tests/dist_lm_check.py): the reference's
    single-device steps at ``microbatches = D`` against the port's over the
    mesh, each step's loss and the parameters after the 3 steps (the first
    takes none: its warmup's learning rate is 0)."""
    got = _load(runs, f"train.{arch}.{mesh}.row0")
    w_metrics, w_params = runs["one"][f"reference.{arch}.{_data_axis(mesh)}"]
    for i, (m, w) in enumerate(zip(got["metrics"], w_metrics, strict=True)):
        loss, want = float(m["loss"]), float(w["loss"])
        assert abs(loss - want) / want < LOSS_RTOL, (arch, mesh, i, loss, want)
    assert float(w_metrics[-1]["lr_scale"]) > 0
    _close_trees(got["state"]["params"], jax.tree.leaves(w_params), f"{arch} over {mesh} against the reference")


# -- (iii), (iv): M = 1, checkpoints -------------------------------------------------------------


def test_expert_axis_of_one_is_the_data_parallel_step_bit_for_bit(runs):
    mesh, data = _load(runs, "m1.mesh.row0"), _load(runs, "m1.data.row0")
    assert _equal_trees(mesh["state"], data["state"])
    assert all(a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
               for a, b in zip(mesh["metrics"], data["metrics"], strict=True))
    assert _equal_trees(_load(runs, "m1.mesh.row1")["state"], mesh["state"])


@pytest.mark.parametrize("arch", check.ONE_RANK)
def test_expert_axis_over_one_rank_is_the_one_process_step_bit_for_bit(runs, arch):
    """A 1x1 layout (the experts over a model group of one, the data
    reduction over a group of one) against the process without ranks:
    every sum over one rank is ``0 + x``, and the gradient norm sums each
    leaf in its logical order, strided (one process) or not (the rank
    path's contiguous gradients)."""
    got = _load(runs, f"lone.{arch}.row0")
    state, metrics = runs["one"][f"{arch}.1"]
    assert _equal_trees(got["state"], state)
    assert all(a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
               for a, b in zip(got["metrics"], metrics, strict=True))


def test_expert_checkpoint_restores_in_one_process(runs):
    cfg = check.config(check.REF_ARCH)
    state = init_train_state(torch.Generator().manual_seed(1), cfg, device="cpu")
    state, step = CheckpointManager(str(runs["dir"] / "ckpt.1x2")).restore(state)
    assert step == check.STEPS
    assert _equal_trees(state, _load(runs, f"train.{check.REF_ARCH}.1x2.row0")["state"])


# -- (v): the launcher ---------------------------------------------------------------------


@pytest.mark.parametrize("arch", check.LAUNCH)
def test_launch_train_runs_moe_over_model_ranks(runs, arch):
    got = _load(runs, f"launch.{arch}")
    want = runs["one"][f"launch.{arch}"]
    assert len(got["losses"]) == len(want) == check.STEPS
    for a, b in zip(got["losses"], want):
        assert abs(a - b) <= METRIC_RTOL * abs(b), (arch, got["losses"], want)
    lines = "\n".join(got["lines"])
    assert "experts=model" in lines and "model-axis collectives over 2 ranks:" in lines and "restarts 0" in lines


# -- (vi): blocks and slots ------------------------------------------------------------------


class _Rank:
    """The block arithmetic of a `TensorParallel` at rank ``rank`` of
    ``world``, with no group."""

    def __init__(self, rank: int, world: int):
        self.rank, self.world = rank, world

    def range(self, n: int) -> tuple[int, int]:
        from repro_torch.distributed.tensor_parallel import block_range

        return block_range(n, self.world, self.rank)


@pytest.mark.parametrize("world,rank", [(2, 1), (3, 0), (3, 2)])
def test_moe_leaves_cut_by_their_axes(world, rank):
    """deepseek's smoke leaves (8 experts of 48, 2 shared; stacked over the
    periods, so every dim is one on) over M = 2: the experts' block; over
    3: every expert's width, w_gate/w_up along their last dim and w_down
    along its rows, in contiguous blocks; the shared experts over ``mlp``;
    the router whole."""
    cfg = check.config("deepseek-moe-16b")
    table = rules_for(cfg, mode="train", multi_pod=False, data_axis=1, model_axis=world)
    ep = world == 2
    assert table["experts"] == ("model" if ep else None) and table["expert_mlp"] == (None if ep else "model")
    blocks = param_blocks(cfg, Rules(table, {"data": 1, "model": world}, model=_Rank(rank, world)))
    whole = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    got, want = blocks.cut(whole)["layers"][0]["ffn"], whole["layers"][0]["ffn"]
    if ep:
        lo, hi = 4 * rank, 4 * rank + 4
        for name in ("w_gate", "w_up", "w_down"):
            assert torch.equal(got[name], want[name][:, lo:hi]), name
    else:
        lo, hi = _Rank(rank, world).range(48)
        assert torch.equal(got["w_gate"], want["w_gate"][..., lo:hi])
        assert torch.equal(got["w_up"], want["w_up"][..., lo:hi])
        assert torch.equal(got["w_down"], want["w_down"][:, :, lo:hi])
    lo, hi = _Rank(rank, world).range(96)
    assert torch.equal(got["shared"]["w_gate"], want["shared"]["w_gate"][..., lo:hi])
    assert torch.equal(got["shared"]["w_up"], want["shared"]["w_up"][..., lo:hi])
    assert torch.equal(got["shared"]["w_down"], want["shared"]["w_down"][:, lo:hi])
    assert torch.equal(got["router"], want["router"])


def test_local_slots_map_a_block_and_send_the_rest_to_its_zero_row():
    a_slot = torch.tensor([[0, 7, 8, 15, 16, 31, 32]], dtype=torch.int32)   # 4 experts of 8 slots; 32 is dropped
    assert _local_slots(a_slot, 8, 16).tolist() == [[8, 8, 0, 7, 8, 8, 8]]
    assert _local_slots(a_slot, 0, 32).tolist() == a_slot.tolist()          # one rank: the slots themselves
    assert _local_slots(a_slot, 24, 32).dtype == torch.int32
