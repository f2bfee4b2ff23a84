"""The port's training-loop fault tolerance (`repro_torch.checkpoint.
CheckpointManager`, `repro_torch.distributed.fault` `FailureInjector`,
`StragglerMonitor`, `Supervisor`): the counterparts of tests/test_training.py's
checkpoint, supervisor and straggler tests, run on the port's own train
state and data.

Beyond the reference's checks: bfloat16 leaves round-trip bit for bit; an
asynchronous save copies every leaf to the host before it returns (the
train step updates the state in place right after) and `wait` re-raises
what the background write raised; ``restore`` copies into the tensors
held; a failure after the latest checkpoint rolls the held state back to it
and replays; a checkpoint of the reference's train state carries
across the packages, both ways.
"""

import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.checkpoint as rckpt  # noqa: E402
import repro.train as rtrain  # noqa: E402
import repro_torch.data as tdata  # noqa: E402
import repro_torch.train as ttrain  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.distributed.fault import FailureInjector, StragglerMonitor, Supervisor  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from test_torch_models import port_config, to_port  # noqa: E402
from test_torch_train import port_train_config  # noqa: E402
from test_training import TCFG, TINY  # noqa: E402

CFG = port_config(TINY)
DATA = tdata.DataConfig(vocab_size=64, global_batch=8, seq_len=32, seed=0)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(seed=0, cfg=CFG):
    return ttrain.init_train_state(torch.Generator().manual_seed(seed), cfg, device="cpu")


def _step_fn():
    step = ttrain.make_train_step(CFG, port_train_config(TCFG))
    return lambda st, i: step(st, tdata.global_batch_at(i, DATA, device="cpu"))


def _bit_equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _clone(tree):
    return tree_map(torch.clone, tree)


def test_checkpoint_roundtrip_bf16_bit_for_bit(tmp_path):
    """The train state of ``tiny`` in bfloat16 (float32 moments): saved and
    restored into the tensors held, bit for bit."""
    import dataclasses

    state = _state(1, dataclasses.replace(CFG, dtype=torch.bfloat16))
    assert state["params"]["embed"]["table"].dtype == torch.bfloat16
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(7, state)
    held = tree_map(torch.zeros_like, state)
    ids = [id(t) for t in tree_leaves(held)]
    back, step = mgr.restore(held)
    assert step == 7 and _bit_equal(back, state)
    assert [id(t) for t in tree_leaves(back)] == ids
    import json

    with open(tmp_path / "step_000000007" / "manifest.json") as f:
        manifest = json.load(f)
    assert "bfloat16" in manifest["dtypes"] and "['params']/['layers']/[0]/['mixer']/['wq']" in manifest["names"]


def test_checkpoint_keep_k_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = {"x": torch.arange(4)}
    for s in (1, 2, 3, 4):
        mgr.save(s, state)
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_checkpoint_async_save_copies_before_returning(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    state = {"x": torch.arange(1000, dtype=torch.float32), "w": torch.ones(3, dtype=torch.bfloat16)}
    mgr.save(1, state, blocking=False)
    state["x"].add_(1.0)  # an in-place step right after the save returns
    state["w"].mul_(3)
    mgr.wait()
    assert mgr.latest_step() == 1
    restored, _ = mgr.restore(state)
    assert torch.equal(restored["x"], torch.arange(1000, dtype=torch.float32))
    assert torch.equal(restored["w"], torch.ones(3, dtype=torch.bfloat16))


def test_checkpoint_wait_raises_the_background_error(tmp_path):
    mgr = CheckpointManager(str(tmp_path))

    def broken(*args):
        raise OSError("disk full")

    mgr._write = broken
    mgr.save(1, {"x": torch.zeros(2)}, blocking=False)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()  # raised once


def test_checkpoint_no_partial_dirs_on_overwrite(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, {"x": torch.zeros(3)})
    mgr.save(5, {"x": torch.ones(3)})  # overwrite same step atomically
    restored, _ = mgr.restore({"x": torch.zeros(3)})
    assert torch.equal(restored["x"], torch.ones(3))
    assert not [d for d in os.listdir(tmp_path) if ".tmp" in d]


def test_train_state_checkpoint_carries_across_packages(tmp_path):
    """The reference's train state of ``tiny`` (nested tuples of layers)
    saved by either package restores in the other, leaf names and bits."""
    ref_state = rtrain.init_train_state(jax.random.PRNGKey(2), TINY)
    rckpt.CheckpointManager(str(tmp_path / "ref"), keep=1).save(3, ref_state)
    port_like = to_port(ref_state)
    got, step = CheckpointManager(str(tmp_path / "ref")).restore(tree_map(torch.zeros_like, port_like))
    assert step == 3 and _bit_equal(got, port_like)

    CheckpointManager(str(tmp_path / "port"), keep=1).save(4, port_like)
    back, step = rckpt.CheckpointManager(str(tmp_path / "port")).restore(ref_state)
    assert step == 4
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref_state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_supervisor_recovers_from_injected_failures(tmp_path):
    """Training with failures at steps 7 and 13 reaches the same final step
    and a decreasing loss; restarts counted."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    sup = Supervisor(_step_fn(), mgr, save_every=5, injector=FailureInjector(fail_at_steps=(7, 13)),
                     async_save=False)
    final_state, final_step = sup.run(_state(), 20)
    assert final_step == 20
    assert sup.restarts == 2
    assert int(final_state["step"]) == 20
    losses = [float(m["loss"]) for m in sup.metrics_log]
    assert losses[-1] < losses[0]


def test_supervisor_straggler_detection(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mon = StragglerMonitor(threshold=4.0)

    def step_fn(st, i):
        # wide margins: 20 ms steps, the straggler 20x that (the reference's)
        time.sleep(0.4 if i == 10 else 0.02)
        return st, {"loss": 0.0}

    sup = Supervisor(step_fn, mgr, save_every=100, straggler=mon, async_save=False)
    sup.run({"x": torch.zeros(1)}, 15)
    assert mon.flagged >= 1
    assert [m["step"] for m in sup.metrics_log if m["straggler"]] == [10]


@pytest.mark.parametrize("async_save", [False, True])
@pytest.mark.parametrize("fail_at", [6, 7])
def test_checkpoint_restore_after_failure_is_bitwise(tmp_path, async_save, fail_at):
    """10 steps straight == 10 steps with a crash before step ``fail_at``,
    restored from the checkpoint of step 6 (saves every 2; the stateless
    pipeline replays the same batches). At 6 the held state is the saved
    one, as in the reference's test; at 7 it is a step ahead, so the
    restore must roll it back and step 6 is replayed."""
    step_fn = _step_fn()
    straight = _state()
    for i in range(10):
        straight, _ = step_fn(straight, i)

    mgr = CheckpointManager(str(tmp_path / "b"), keep=5)
    sup = Supervisor(step_fn, mgr, save_every=2, injector=FailureInjector((fail_at,)), async_save=async_save)
    final, step = sup.run(_state(), 10)
    assert step == 10 and sup.restarts == 1
    assert [m["step"] for m in sup.metrics_log] == [*range(fail_at), *range(6, 10)]
    assert _bit_equal(final["params"], straight["params"]) and _bit_equal(final["opt"], straight["opt"])
    assert int(final["step"]) == 10


def test_supervisor_replays_on_the_held_state_before_any_checkpoint(tmp_path):
    """The reference's quirk, kept: a failure before the first checkpoint
    replays from ``start_step`` on the state as it stands."""
    step_fn = _step_fn()
    sup = Supervisor(step_fn, CheckpointManager(str(tmp_path)), save_every=100,
                     injector=FailureInjector((3,)), async_save=False)
    final, step = sup.run(_state(), 5)
    assert step == 5 and sup.restarts == 1
    assert [m["step"] for m in sup.metrics_log] == [0, 1, 2, 0, 1, 2, 3, 4]
    assert int(final["step"]) == 8  # eight updates on the one state
