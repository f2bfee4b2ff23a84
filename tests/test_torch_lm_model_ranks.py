"""The LM stack's model axis over ranks (tensor and vocabulary parallelism),
one process a rank (gloo on the CPU), against the one-process step and
against the reference.

One module-scoped fixture writes the inputs (each config's whole initial
train state and its batches; phi3's carried over to the reference as
well), starts the 4 ranks of tests/lm_model_ranks_check.py joined through a
``FileStore`` in a temporary directory, and meanwhile runs in this process
the one-process port steps, the reference's single-device step and the
launcher's one-process run; it waits for every rank under one join
timeout (a hang fails in seconds, never at the suite's limit).

- (i) 3 steps of phi3-mini-3.8b's, starcoder2-7b's (6 heads over 4 ranks
  unevenly; 2 kv heads replicated at M = 4, blocked at M = 2) and
  gemma3-27b's (tied table, local window) smoke configs over meshes 1x2,
  2x2 and 1x4, and of whisper-tiny's and llava-next-mistral-7b's over
  1x2: every metric within rtol 1e-5 of the one-process step at
  ``microbatches = D``, ``tokens`` and ``accuracy`` exact, the gathered
  parameters within check A's rtol 2e-3 and atol 2e-5, both data rows of
  2x2 bit-equal;
- (ii) phi3 over each mesh against the reference's single-device steps
  (check A's tolerances: each loss rtol 1e-4, the parameters after 3
  steps rtol 2e-3, atol 2e-5);
- (iii) a 2x1 layout (the model path over groups of one) bit-equal to the
  data-parallel step on the same 2 ranks;
- (iv) the 1x2 run's checkpoint restored in one process, bit-equal to the
  gathered tree;
- (v) a failure on one rank of 2x2 restoring every rank, bit-equal to the
  run without it;
- (vi) ``launch.train``'s run over 2x2, within rtol 1e-5 of its
  one-process run at ``--microbatches 2``, and its refusals by name.
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

import lm_model_ranks_check as check  # noqa: E402
import repro.configs.registry as rreg  # noqa: E402
import repro.train as rtrain  # noqa: E402
from repro.optim import AdamWConfig, ScheduleConfig  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.distributed.ranks import check_axis_request  # noqa: E402
from repro_torch.distributed.tensor_parallel import block_range, check_model_axis  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import params_to_numpy  # noqa: E402
from repro_torch.train import init_train_state  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
JOIN_TIMEOUT_S = 120.0
METRIC_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 2e-3, 2e-5     # check A (tests/dist_lm_check.py)
LOSS_RTOL = 1e-4                        # check A
EXACT = ("tokens", "accuracy")
CASES = [(arch, mesh) for arch in check.CONFIGS for mesh in check.MESHES] + [(a, "1x2") for a in check.ONE_MESH]


def reference_steps(inputs: dict):
    """The reference's single-device steps of phi3's smoke config from the
    same state and batches: (each step's metrics, the parameters after the
    last) as numpy."""
    cfg = rreg.get_smoke_config(check.REF_ARCH)
    tcfg = rtrain.TrainConfig(optimizer=AdamWConfig(lr=1e-3), schedule=ScheduleConfig(warmup_steps=2, total_steps=50))
    state = jax.tree.map(jnp.asarray, params_to_numpy(inputs["state"]))
    step = jax.jit(rtrain.make_train_step(cfg, tcfg))
    metrics = []
    for b in inputs["batches"][:check.STEPS]:
        state, m = step(state, {k: jnp.asarray(v.numpy()) for k, v in b.items()})
        metrics.append(jax.tree.map(np.asarray, m))
    return metrics, jax.tree.map(np.asarray, state["params"])


def _one_process(inputs: dict, tmp: Path) -> dict:
    """The one-process runs: each config at ``microbatches`` 1 and 2, the
    reference's step, the launcher's run."""
    one = {}
    for arch in check.CONFIGS + check.ONE_MESH:
        for k in (1, 2) if arch in check.CONFIGS else (1,):
            one[f"{arch}.{k}"] = check.train(arch, inputs[arch], None, k)[:2]
    one["reference"] = reference_steps(inputs[check.REF_ARCH])
    args = launch_train.parser().parse_args(check.LAUNCH_ONE + ["--microbatches", "2", "--ckpt-dir",
                                                                str(tmp / "ckpt.one")])
    one["launch"] = launch_train.train(args, device=torch.device("cpu"), out=lambda *a: None)
    return one


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results and the one process's, from one spawn."""
    tmp = tmp_path_factory.mktemp("lm_model_ranks")
    inputs = {arch: check.make_inputs(arch) for arch in check.CONFIGS + check.ONE_MESH}
    torch.save(inputs, tmp / "inputs.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), str(REPO / "tests"), os.environ.get("PYTHONPATH", "")]))
    (tmp / "store").mkdir()
    procs, logs = [], []
    try:
        for r in range(check.WORLD):
            logs.append(open(tmp / f"rank{r}.log", "w"))
            procs.append(subprocess.Popen([sys.executable, str(REPO / "tests" / "lm_model_ranks_check.py"), str(r),
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
def test_model_axis_step_matches_one_process(runs, arch, mesh):
    d = check.MESHES[mesh][0]
    got = _load(runs, f"train.{arch}.{mesh}.row0")
    state, metrics = runs["one"][f"{arch}.{d}"]
    assert len(got["metrics"]) == len(metrics) == check.STEPS
    for i, (g, w) in enumerate(zip(got["metrics"], metrics)):
        assert g.keys() == w.keys()
        for k in w:
            a, b = float(g[k]), float(w[k])
            if k in EXACT:
                assert a == b, (arch, mesh, i, k, a, b)
            else:
                assert abs(a - b) <= METRIC_RTOL * max(abs(b), 1e-6), (arch, mesh, i, k, a, b)
    assert int(got["state"]["step"]) == check.STEPS
    _close_trees(got["state"]["params"], state["params"], f"{arch} over {mesh}")
    for r in range(1, d):  # every data row holds the same replica
        assert _equal_trees(_load(runs, f"train.{arch}.{mesh}.row{r}")["state"], got["state"]), (arch, mesh, r)
    # each step crossed the Megatron boundaries over the model group: a sum after every attention and MLP block
    # and the embedding, forward and again in the recompute, and a sum of every column-parallel input's cotangent
    assert got["counts"]["sum_out"] >= check.STEPS * (2 * get_smoke_config(arch).total_layers + 1)
    assert got["counts"]["copy_in"] >= check.STEPS * (2 * get_smoke_config(arch).total_layers + 1)
    assert got["counts"]["norm"] == check.STEPS


@pytest.mark.parametrize("mesh", list(check.MESHES))
def test_phi3_over_model_ranks_matches_the_reference(runs, mesh):
    """Check A's tolerances (tests/dist_lm_check.py), the reference's
    single-device steps against the port's over the mesh: each step's loss,
    and the parameters after the 3 steps (the first takes none: its
    warmup's learning rate is 0)."""
    got = _load(runs, f"train.{check.REF_ARCH}.{mesh}.row0")
    w_metrics, w_params = runs["one"]["reference"]
    for i, (m, w) in enumerate(zip(got["metrics"], w_metrics, strict=True)):
        loss, want = float(m["loss"]), float(w["loss"])
        assert abs(loss - want) / want < LOSS_RTOL, (mesh, i, loss, want)
    assert float(w_metrics[-1]["lr_scale"]) > 0
    _close_trees(got["state"]["params"], jax.tree.leaves(w_params), f"{mesh} against the reference")


# -- (iii), (iv), (v): M = 1, checkpoints, the supervisor ---------------------------------------


def test_model_axis_of_one_is_the_data_parallel_step_bit_for_bit(runs):
    mesh, data = _load(runs, "m1.mesh.row0"), _load(runs, "m1.data.row0")
    assert _equal_trees(mesh["state"], data["state"])
    assert all(a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
               for a, b in zip(mesh["metrics"], data["metrics"], strict=True))
    assert _equal_trees(_load(runs, "m1.mesh.row1")["state"], mesh["state"])


def test_checkpoint_over_model_ranks_restores_in_one_process(runs):
    cfg = get_smoke_config(check.REF_ARCH)
    state = init_train_state(torch.Generator().manual_seed(1), cfg, device="cpu")
    state, step = CheckpointManager(str(runs["dir"] / "ckpt.1x2")).restore(state)
    assert step == check.STEPS
    assert _equal_trees(state, _load(runs, f"train.{check.REF_ARCH}.1x2.row0")["state"])


def test_failure_on_one_rank_restores_every_rank(runs):
    sup = check.SUPERVISED
    failed, straight = _load(runs, "supervised.True.row0"), _load(runs, "supervised.False.row0")
    # the failure before step 3 restored the save of step 2 on all 4 ranks, which replayed step 2
    assert failed["restarts"] == [1] * check.WORLD and straight["restarts"] == [0] * check.WORLD
    assert failed["steps"] == list(range(sup["fail_at"])) + list(range(sup["fail_at"] - 1, sup["steps"]))
    assert straight["steps"] == list(range(sup["steps"]))
    assert _equal_trees(failed["state"], straight["state"])
    assert _equal_trees(_load(runs, "supervised.True.row1")["state"], straight["state"])
    assert sorted(os.listdir(runs["dir"] / "ckpt.supervised.True")) == ["LATEST", "step_000000002",
                                                                        "step_000000004"]


# -- (vi): the launcher ---------------------------------------------------------------------


def test_launch_train_over_model_ranks_matches_one_process(runs):
    got = _load(runs, "launch")
    want = runs["one"]["launch"]
    assert len(got["losses"]) == len(want) == 3
    for a, b in zip(got["losses"], want):
        assert abs(a - b) <= METRIC_RTOL * abs(b), (got["losses"], want)
    lines = "\n".join(got["lines"])
    assert "gradient reduction over 2 ranks:" in lines and "model-axis collectives over 2 ranks:" in lines
    assert "restarts 0" in lines


def test_launch_train_refuses_the_model_axis_by_name(capsys):
    argv = ["--smoke", "--steps", "1", "--global-batch", "4", "--device", "cpu"]
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", check.REF_ARCH, *argv, "--mesh", "2x2", "--ranks", "3"])
    assert "--ranks 3 must equal the data axis of --mesh 2x2 (2), or D·M (4)" in capsys.readouterr().err
    for arch, kinds in (("jamba-v0.1-52b", "mamba"), ("xlstm-1.3b", "mlstm, slstm")):
        with pytest.raises(SystemExit):
            launch_train.main(["--arch", arch, *argv, "--mesh", "1x2", "--ranks", "2"])
        assert f"has {kinds} layers: the model axis over 2 ranks splits attention, dense-MLP and MoE layers only" in \
            capsys.readouterr().err, arch
    for arch in ("deepseek-moe-16b", "mixtral-8x22b"):  # MoE layers split over the model ranks
        for m in (2, 4):
            check_model_axis(get_smoke_config(arch), m)
    # no card here: more ranks than cards, and nothing runs on the CPU in their place
    args = launch_train.parser().parse_args(["--arch", check.REF_ARCH, *argv[:-2], "--mesh", "1x2", "--ranks", "2"])
    with pytest.raises(RuntimeError, match="2 ranks need 2 cards, one a rank, but 0 are visible"):
        launch_train.run_ranks(args)


def test_layout_requests_and_blocks():
    assert check_axis_request(4, 2, model=2) == 1 and check_axis_request(4, 1, model=4, n_cards=4) == 1
    with pytest.raises(ValueError, match="6 ranks do not lay out as the data axis by a model axis of 4"):
        check_axis_request(6, 2, model=4)
    with pytest.raises(RuntimeError, match="4 ranks need 4 cards, one a rank, but 2 are visible"):
        check_axis_request(4, 2, model=2, n_cards=2)
    # 36 heads over 16 ranks and 6 over 4: contiguous blocks, the first n % M one larger
    assert [block_range(6, 4, r) for r in range(4)] == [(0, 2), (2, 4), (4, 5), (5, 6)]
    blocks = [block_range(36, 16, r) for r in range(16)]
    assert blocks[0] == (0, 3) and blocks[3] == (9, 12) and blocks[4] == (12, 14) and blocks[-1] == (34, 36)
    check_model_axis(get_smoke_config("deepseek-moe-16b"), 1)  # whole on each rank: nothing to refuse
    with pytest.raises(ValueError, match="xlstm-1.3b-smoke has mlstm, slstm layers"):
        check_model_axis(get_smoke_config("xlstm-1.3b"), 4)
