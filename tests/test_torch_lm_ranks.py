"""The LM stack's data and pipe axes over ranks, one process a rank (gloo on
the CPU), against the one-process stack and against the reference.

One module-scoped fixture writes the inputs (the reference's initial train
states and batches, carried over as the port's tensors), starts the
reference's runs in two subprocesses with 4 forced host devices (this
file's ``__main__``, one a config), the 8 ranks of tests/lm_ranks_check.py joined through a
``FileStore`` in a temporary directory, and two `launch.train` runs (over
2 ranks and in one process); it runs the same cases with no ranks in this
process meanwhile, and waits for every process under one join timeout (a
hang fails in seconds, never at the suite's limit).

- (i) the train step over 2 and 4 ranks, 3 steps of check A's
  ``tiny_moe`` and of phi3-mini-3.8b's smoke config at a global batch of
  8 x 32: parameters, moments and metrics bit-equal to the one-process
  step at ``microbatches = N``, every rank's replica equal to the others';
  with 2 microbatches a rank over 2 ranks, within the train tests'
  tolerances of ``microbatches = 4`` (the float32 sums group by rank);
- (ii) the same steps against the reference's step at ``microbatches =
  N`` (tests/test_torch_train.py's tolerances);
- (iii) 2 ranks against the reference's check A (GSPMD on a 2x2 host
  mesh) after one step: loss within rtol 1e-4, parameters within rtol
  2e-3 and atol 2e-5;
- (iv) the int8 error-feedback reduction and the exact mean, and check
  C's 60 steps with each, over 1, 2, 4 and 8 ranks, bit-equal to the
  stacked runs;
- (v) GPipe's output and stage gradients over 2 and 4 ranks bit-equal to
  the stacked run, every exchange run backwards on every rank;
- (vi) a `FailureInjector` failure at step 3 on rank 1 alone, saves every
  2: every rank restores step 2, the final state is bit-equal to an
  uninterrupted run, and only rank 0 wrote files;
- (vii) ``launch.train --smoke --mesh 2 --ranks 2 --device cpu`` prints
  the losses of ``--microbatches 2``, and each refusal names its cause.
"""

import os
import pickle
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import lm_ranks_check as check  # noqa: E402
import repro.configs.registry as rreg  # noqa: E402
import repro.data as rdata  # noqa: E402
import repro.train as rtrain  # noqa: E402
from repro.models import LayerSpec, ModelConfig, MoEConfig  # noqa: E402
from repro.optim import AdamWConfig, ScheduleConfig  # noqa: E402
from repro_torch.distributed.ranks import AxisRanks, check_axis_request  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_models import assert_trees, to_port  # noqa: E402
from test_torch_train import REL, assert_metrics, assert_params_after_adam  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
JOIN_TIMEOUT_S = 240.0
ARGV = ["--arch", check.DENSE_ARCH, "--smoke", "--steps", "4", "--global-batch", "8", "--seq", "32", "--device", "cpu"]


# -- the reference, in the subprocess -------------------------------------------------------


def ref_configs() -> dict:
    tiny_moe = ModelConfig(name="tiny_moe", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=64,
                           pattern=(LayerSpec("attn", "moe"),),
                           moe=MoEConfig(n_experts=4, top_k=2, capacity_factor=4.0))
    return {"tiny_moe": tiny_moe, "dense": rreg.get_smoke_config(check.DENSE_ARCH)}


def ref_train_config(microbatches: int = 1):
    """Check A's `TrainConfig` (tests/dist_lm_check.py)."""
    return rtrain.TrainConfig(optimizer=AdamWConfig(lr=1e-3), schedule=ScheduleConfig(warmup_steps=2, total_steps=50),
                              microbatches=microbatches)


def ref_init(cfg):
    """The reference's initial train state of ``cfg`` from ``PRNGKey(0)``,
    jitted (its eager init costs seconds a config; the two differ in their
    random draws, so every process here takes the jitted one)."""
    return jax.jit(rtrain.init_train_state, static_argnums=1)(jax.random.PRNGKey(0), cfg)


def ref_data(cfg):
    return rdata.DataConfig(vocab_size=cfg.vocab_size, global_batch=8, seq_len=32, seed=0)


def _reference_main(out: str, name: str) -> None:
    """Config ``name``'s 3 steps at ``microbatches`` 2 and 4, and for
    ``tiny_moe`` check A's sharded step on a 2x2 (data, model) mesh."""
    results = {}
    cfg = ref_configs()[name]
    batches = [rdata.global_batch_at(i, ref_data(cfg)) for i in range(check.STEPS)]
    for n in check.WORLDS:
        state = ref_init(cfg)
        step = jax.jit(rtrain.make_train_step(cfg, ref_train_config(n)))
        runs = []
        for b in batches:
            state, m = step(state, b)
            runs.append((jax.tree.map(np.asarray, state), jax.tree.map(np.asarray, m)))
        results[f"{name}.{n}"] = runs
    if name == "tiny_moe":
        results["check_a"] = _check_a(cfg)
    with open(os.path.join(out, f"reference.{name}.pkl"), "wb") as f:
        pickle.dump(results, f)


def _check_a(cfg):
    """Check A's sharded step (tests/dist_lm_check.py): the state and the
    metrics."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.compat import make_mesh_compat, set_mesh_compat
    from repro.distributed.sharding import Rules, train_rules, tree_specs, use_rules
    from repro.models.transformer import param_axes

    state = ref_init(cfg)
    mesh = make_mesh_compat((2, 2), ("data", "model"))
    rules = Rules(train_rules(multi_pod=False), mesh)
    pspecs = tree_specs(param_axes(cfg), rules)

    def put(tree, specs):
        return jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), tree, specs)

    rep = NamedSharding(mesh, P())
    sh_state = {"params": put(state["params"], pspecs),
                "opt": {"mu": put(state["opt"]["mu"], pspecs), "nu": put(state["opt"]["nu"], pspecs),
                        "count": jax.device_put(state["opt"]["count"], rep)},
                "step": jax.device_put(state["step"], rep)}
    batch = jax.tree.map(lambda x: jax.device_put(x, NamedSharding(mesh, P(("data",), None))),
                         rdata.global_batch_at(0, ref_data(cfg)))
    with set_mesh_compat(mesh), use_rules(rules):
        got_state, got_m = jax.jit(rtrain.make_train_step(cfg, ref_train_config()))(sh_state, batch)
    return jax.tree.map(np.asarray, got_state), jax.tree.map(np.asarray, got_m)


# -- the fixture ----------------------------------------------------------------------------


def make_inputs(path: Path) -> None:
    """The reference's initial train state of each config and its batches,
    as the port's tensors, for the ranks and this process."""
    data = {}
    for name, cfg in ref_configs().items():
        state = to_port(ref_init(cfg))
        batches = [{k: torch.from_numpy(np.array(v)) for k, v in rdata.global_batch_at(i, ref_data(cfg)).items()}
                   for i in range(check.SUPERVISED["steps"])]
        data[name] = {"state": state, "batches": batches}
    torch.save(data, path)


def _wait(procs: dict, logs: Path, deadline: float) -> None:
    """Join every process by ``deadline``; on a timeout or a failure kill
    the rest and fail with the tail of each log."""
    failed = []
    for name, proc in procs.items():
        try:
            rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            rc = "timeout"
        if rc != 0:
            failed.append((name, rc))
            break
    if failed:
        for proc in procs.values():
            proc.kill()
            proc.wait()
        tails = {name: (logs / f"{name}.log").read_text()[-3000:] for name in procs}
        pytest.fail(f"{failed} (join timeout {JOIN_TIMEOUT_S} s); logs: {tails}")


def _one_process(inputs: Path, tmp: Path) -> dict:
    """The stacked runs of every case."""
    data = torch.load(inputs, weights_only=True)
    cfgs = check.port_configs()
    one = {"reductions": check.reductions(None), "pipeline": check.pipeline(None)}
    for name, cfg in cfgs.items():
        for n in check.WORLDS:
            one[f"train.{name}.{n}"] = check.train(data[name]["state"], data[name]["batches"], cfg, None, n)
    step = make_train_step(cfgs["tiny_moe"], check.train_config(check.SUPERVISED["world"]))
    state = check.clone_tree(data["tiny_moe"]["state"])
    for b in data["tiny_moe"]["batches"][:check.SUPERVISED["steps"]]:
        state, _ = step(state, b)
    one["supervised"] = state
    return one


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results, the reference's, the launcher's lines and the
    one process's, from one spawn."""
    tmp = tmp_path_factory.mktemp("lm_ranks")
    inputs = tmp / "inputs.pt"
    make_inputs(inputs)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO / "src"), str(REPO / "tests"),
                                                       os.environ.get("PYTHONPATH", "")]))
    procs = {}

    def start(name, argv, **kw):
        log = open(tmp / f"{name}.log", "w")
        procs[name] = subprocess.Popen([sys.executable, *argv], env=dict(env, **kw), stdout=log,
                                       stderr=subprocess.STDOUT, cwd=str(tmp))

    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        for name in ("tiny_moe", "dense"):
            start(f"reference.{name}", [__file__, "--reference", str(tmp), name], JAX_PLATFORMS="cpu",
                  XLA_FLAGS="--xla_force_host_platform_device_count=4")
        (tmp / "store").mkdir()
        for r in range(check.WORLD):
            start(f"rank{r}", [str(REPO / "tests" / "lm_ranks_check.py"), str(r), str(check.WORLD),
                               str(tmp / "store"), str(tmp), str(inputs)], OMP_NUM_THREADS="1")
        start("launch_ranks", ["-m", "repro_torch.launch.train", *ARGV, "--mesh", "2", "--ranks", "2", "--ckpt-dir",
                               str(tmp / "launch_ranks")], OMP_NUM_THREADS="1")
        start("launch_one", ["-m", "repro_torch.launch.train", *ARGV, "--microbatches", "2", "--ckpt-dir",
                             str(tmp / "launch_one")], OMP_NUM_THREADS="1")
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            one = _one_process(inputs, tmp)
        finally:
            torch.set_num_threads(n)
        _wait(procs, tmp, deadline)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    ref = {}
    for name in ("tiny_moe", "dense"):
        with open(tmp / f"reference.{name}.pkl", "rb") as f:
            ref.update(pickle.load(f))
    yield {"dir": tmp, "one": one, "ref": ref}


def _rank_runs(tmp: Path, name: str, n: int, k: int) -> list:
    return [torch.load(tmp / f"train.{name}.{n}.{k}.rank{r}.pt", weights_only=True) for r in range(n)]


def _equal_trees(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _equal_metrics(a: list, b: list) -> bool:
    return len(a) == len(b) and all(x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x)
                                    for x, y in zip(a, b))


# -- (i), (ii), (iii): the data-parallel train step ---------------------------------------


@pytest.mark.parametrize("n", check.WORLDS)
@pytest.mark.parametrize("name", ["tiny_moe", "dense"])
def test_train_step_over_ranks_is_the_microbatched_step(runs, name, n):
    ranks = _rank_runs(runs["dir"], name, n, 1)
    state, metrics = runs["one"][f"train.{name}.{n}"]
    assert int(state["step"]) == check.STEPS and float(metrics[-1]["lr_scale"]) > 0
    for r, got in enumerate(ranks):
        assert _equal_trees(got["state"], state), (name, n, r)
        assert _equal_metrics(got["metrics"], metrics), (name, n, r)
    # every gradient crossed in the reduction's gathers, the larger leaves in several chunks; the metrics in
    # their own
    chunks = sum(-(-p.numel() * 4 // check.CHUNK_BYTES) for p in tree_leaves(state["params"]))
    assert ranks[0]["counts"]["reduce_gather"] == check.STEPS * chunks > check.STEPS * len(tree_leaves(state["params"]))
    assert ranks[0]["counts"]["gather"] == check.STEPS * (len(metrics[0]) - 2)  # not grad_norm, lr_scale


def test_microbatches_within_ranks_group_the_sums_by_rank(runs):
    """2 ranks of 2 microbatches against one process of 4: the float32
    contributions add by rank first, so within rounding, not bit for bit."""
    ranks = _rank_runs(runs["dir"], "tiny_moe", 2, 2)
    state, metrics = runs["one"]["train.tiny_moe.4"]
    assert _equal_trees(ranks[0]["state"], ranks[1]["state"])
    for got, want in zip(ranks[0]["metrics"], metrics):
        assert_metrics(got, {k: v.numpy() for k, v in want.items()}, "2 ranks x 2 microbatches")
    assert_trees(ranks[0]["state"]["opt"], state["opt"], REL, "opt")
    lr = sum(1e-3 * float(m["lr_scale"]) for m in metrics)
    assert_params_after_adam(ranks[0]["state"]["params"], state["params"], lr)


@pytest.mark.parametrize("n", check.WORLDS)
@pytest.mark.parametrize("name", ["tiny_moe", "dense"])
def test_train_step_over_ranks_matches_the_reference(runs, name, n):
    got = _rank_runs(runs["dir"], name, n, 1)[0]
    want = runs["ref"][f"{name}.{n}"]
    for i, (m, (_, w_m)) in enumerate(zip(got["metrics"], want)):
        assert_metrics(m, w_m, f"{name} over {n} ranks, step {i + 1}")
    w_state = want[-1][0]
    assert int(got["state"]["step"]) == int(w_state["step"]) == check.STEPS
    lr = sum(1e-3 * float(w_m["lr_scale"]) for _, w_m in want)
    assert lr > 0
    assert_params_after_adam(got["state"]["params"], w_state["params"], lr)


def test_two_ranks_match_check_a(runs):
    """Check A's own comparison (tests/dist_lm_check.py), the reference's
    sharded step against the port's over 2 ranks, after one step."""
    w_state, w_m = runs["ref"]["check_a"]
    data = torch.load(runs["dir"] / "inputs.pt", weights_only=True)
    cfg = check.port_configs()["tiny_moe"]
    state, metrics = check.train(data["tiny_moe"]["state"], data["tiny_moe"]["batches"][:1], cfg, None, 2)
    got = _rank_runs(runs["dir"], "tiny_moe", 2, 1)[0]
    # the ranks' first step is the one-process step at microbatches = 2
    assert_metrics(metrics[0], {k: v.numpy() for k, v in got["metrics"][0].items()}, "first step")
    loss, want = float(metrics[0]["loss"]), float(w_m["loss"])
    assert abs(loss - want) / want < 1e-4, (loss, want)
    for a, b in zip(tree_leaves(state["params"]), jax.tree.leaves(w_state["params"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-3, atol=2e-5)


# -- (iv), (v): the reductions and GPipe --------------------------------------------------


@pytest.mark.parametrize("n", check.REDUCE_WORLDS)
def test_reductions_over_ranks_bit_equal_the_stacked_call(runs, n):
    got = torch.load(runs["dir"] / f"reductions.{n}.pt", weights_only=True)
    want = runs["one"]["reductions"]
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), (n, k)
    assert float(want["torch.float32.2.res.w"].abs().max()) > 0
    # check C's criteria hold for the runs that are equal
    exact, comp = (want[f"check_c.{c}.losses"].tolist() for c in (False, True))
    assert check.example().dp_criteria(exact, comp)


@pytest.mark.parametrize("n", check.WORLDS)
def test_pipeline_over_ranks_bit_equal_the_stacked_run(runs, n):
    got = torch.load(runs["dir"] / f"pipeline.{n}.pt", weights_only=True)
    want = runs["one"]["pipeline"]
    for name, w, x, _ in check.pipeline_cases():
        for part in ("out", "grad"):
            key = f"{name}.{part}"
            assert torch.equal(got[key], want[key]), (n, key)
        # every tick but the last exchanges, and every exchange ran backwards on every rank
        ticks = x.shape[0] + w.shape[0] - 1
        assert got[f"{name}.backwards"].tolist() == [ticks - 1] * n, (n, name)
        assert float(want[f"{name}.grad"].abs().max()) > 0


# -- (vi): the supervisor over ranks -------------------------------------------------------


def test_failure_on_one_rank_restores_every_rank(runs):
    sup = check.SUPERVISED
    n = sup["world"]
    failed = [torch.load(runs["dir"] / f"supervised.True.rank{r}.pt", weights_only=True) for r in range(n)]
    straight = [torch.load(runs["dir"] / f"supervised.False.rank{r}.pt", weights_only=True) for r in range(n)]
    replay = list(range(sup["fail_at"])) + list(range(sup["fail_at"] - 1, sup["steps"]))
    for r in range(n):
        # the failure before step 3 restored the save of step 2 on every rank, which replayed step 2
        assert failed[r]["restarts"] == 1 and failed[r]["steps"] == replay and failed[r]["last"] == sup["steps"], r
        assert straight[r]["restarts"] == 0 and straight[r]["steps"] == list(range(sup["steps"])), r
        assert _equal_trees(failed[r]["state"], straight[r]["state"]), r
        assert _equal_trees(failed[r]["state"], runs["one"]["supervised"]), r
    # rank 0 wrote the saves of steps 2, 4 and 6 (and 6 again as the last); no other rank wrote
    assert [f["writes"] for f in failed] == [sup["steps"] // sup["save_every"], 0]
    assert sorted(os.listdir(runs["dir"] / "ckpt.fail")) == ["LATEST", "step_000000002", "step_000000004",
                                                             "step_000000006"]


def test_failure_inside_one_ranks_step_ends_the_run(runs):
    """Not recovered (ROADMAP queue C): rank 1 raises its own error, rank 0
    the group's, each after at most the group's timeout and a margin."""
    got = [torch.load(runs["dir"] / f"step_failure.rank{r}.pt", weights_only=True) for r in range(2)]
    assert "a failure inside rank 1's step 1" in got[1]["raised"] and got[1]["restarts"] == 0
    assert got[0]["raised"] is not None and "a failure inside" not in got[0]["raised"] and got[0]["restarts"] == 0
    assert got[0]["seconds"] < check.STEP_FAILURE["timeout_s"] + 30, got[0]


# -- (vii): the launcher --------------------------------------------------------------------


def _losses(log: Path) -> str:
    return re.search(r"losses ([0-9. ]+);", log.read_text()).group(1)


def test_launch_train_over_ranks_prints_the_microbatched_losses(runs):
    lines = (runs["dir"] / "launch_ranks.log").read_text()
    assert _losses(runs["dir"] / "launch_ranks.log") == _losses(runs["dir"] / "launch_one.log")
    assert "gradient reduction over 2 ranks:" in lines and "MB a rank" in lines
    assert "restarts 0" in lines


def test_launch_train_refuses_by_name(capsys):
    with pytest.raises(SystemExit):
        launch_train.main(ARGV + ["--ranks", "2"])
    assert "--ranks spreads the data axis over processes: name it with --mesh" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        launch_train.main(ARGV + ["--mesh", "2x2", "--ranks", "3"])
    assert "--ranks 3 must equal the data axis of --mesh 2x2 (2)" in capsys.readouterr().err
    # no card here: more ranks than cards, and nothing runs on the CPU in their place
    args = launch_train.parser().parse_args(ARGV[:-2] + ["--mesh", "2", "--ranks", "2"])
    with pytest.raises(RuntimeError, match="2 ranks need 2 cards, one a rank, but 0 are visible"):
        launch_train.run_ranks(args)


def test_axis_request_refusals():
    assert check_axis_request(4, 8) == 2 and check_axis_request(2, 4, n_cards=2, axis="pipe") == 2
    with pytest.raises(RuntimeError, match="4 ranks need 4 cards, one a rank, but 1 are visible"):
        check_axis_request(4, 8, n_cards=1)
    with pytest.raises(ValueError, match="3 ranks do not divide the pipe axis of 4"):
        check_axis_request(3, 4, axis="pipe")
    with pytest.raises(ValueError, match="a data-parallel step takes one data shard a rank"):
        make_train_step(check.port_configs()["tiny_moe"], check.train_config(), AxisRanks("data", 4, 0, 2))
    ranks = AxisRanks("pipe", 4, 1, 2)
    assert ranks.n_local == 2 and ranks.start == 2 and ranks.is_last
    assert torch.equal(ranks.block(torch.arange(4)), torch.tensor([2, 3]))


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    _reference_main(sys.argv[2], sys.argv[3])
