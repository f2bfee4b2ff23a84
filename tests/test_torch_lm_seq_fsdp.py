"""Sequence parallelism and the ``fsdp`` rule over ranks, one process a rank
(gloo on the CPU), against the one-process step and against the reference.

One module-scoped fixture starts the 4 ranks of tests/lm_seq_fsdp_check.py
joined through a ``FileStore`` in a temporary directory, writes their
inputs meanwhile (the reference's initial train state of check A's
``tiny_moe`` and its batches, carried over as numpy), and then runs in this process
the one-process port steps, the reference's single-device steps and the
launcher's one-process run; it waits for every rank under one join
timeout. Every layout runs through `rules_for`'s table: the stream is cut
by sequence over the model ranks, each data rank holds its slice of every
``fsdp`` leaf and of its two moments, and the experts are split over the
model ranks (by expert over 2, by width over 3).

- (i) check A (tests/dist_lm_check.py) over 2x2: FSDP, TP, SP and EP
  together against the reference's single-device steps at
  ``microbatches = 2``, each loss within rtol 1e-4 and the parameters
  after 3 steps within rtol 2e-3, atol 2e-5;
- (ii) 1x2, 2x2 and 1x3 (32 positions over 3: blocks of 11, 11 and 10)
  against the port's one-process step at ``microbatches = D``: every
  metric and the gathered state within rtol 1e-5 (``tokens`` and
  ``accuracy`` exact), the norm scales bit-equal on every model rank;
- (iii) the mutation: the norm scales' gradients left unsummed over the
  model ranks fail (ii)'s comparison over 1x2; one head, which the table
  leaves whole over 2 ranks, within (ii)'s tolerances over 1x2;
- (iv) 2x1 (the ``fsdp`` rule alone) within rtol 1e-5 of the
  data-parallel step on the same ranks: bit for bit the first step's
  loss and every metric of it but the gradient norm, whose squares group
  by slice; 1x1 bit for bit the one-process step;
- (v) after 2x2's steps each rank holds ``1/D`` of every ``fsdp`` leaf and
  of both its moments, and ``1/M`` of every leaf the table places on
  ``model``, leaf by leaf;
- (vi) a checkpoint written over 2x2 restores over 2x2 and over 1x1, and
  one step more from it is bit for bit the uninterrupted 2x2 run and the
  one-process step from the same checkpoint;
- (vii) ``launch.train --mesh 2x2 --ranks 4`` of ``tiny_moe`` within rtol
  1e-5 of its one-process run at ``--microbatches 2``, and its line of
  the data axis's collectives;
- (viii) the two-axis cut of uneven blocks, without a spawn, and the
  data group's gather and reduce-scatter of uneven blocks over 3 ranks.
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

import lm_seq_fsdp_check as check  # noqa: E402
import repro.train as rtrain  # noqa: E402
from repro.data import DataConfig as RDataConfig, global_batch_at as r_global_batch_at  # noqa: E402
from repro.models import LayerSpec as RLayerSpec, ModelConfig as RModelConfig, MoEConfig as RMoEConfig  # noqa: E402
from repro.optim import AdamWConfig, ScheduleConfig  # noqa: E402
from repro_torch.checkpoint import _flatten_with_names  # noqa: E402
from repro_torch.distributed.ranks import block_range, stack_sum  # noqa: E402
from repro_torch.distributed.sharding import Rules, rules_for  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import init_params, params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.train import init_train_state  # noqa: E402
from repro_torch.train.step import param_blocks, state_blocks  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
JOIN_TIMEOUT_S = 120.0
METRIC_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 2e-3, 2e-5     # check A
LOSS_RTOL = 1e-4                        # check A
EXACT = ("tokens", "accuracy")
ONE_PROCESS = ("1x2", "2x2", "1x3")


def reference_config():
    return RModelConfig(name="tiny_moe", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=64,
                        pattern=(RLayerSpec("attn", "moe"),), moe=RMoEConfig(n_experts=4, top_k=2, capacity_factor=4.0))


def make_inputs():
    """The reference's initial state of check A's model (its init under
    `jax.jit`) and STEPS of its batches (check A's data), as the port's
    tensors."""
    state = jax.jit(rtrain.init_train_state, static_argnums=1)(jax.random.PRNGKey(0), reference_config())
    data = RDataConfig(vocab_size=64, global_batch=check.BATCH, seq_len=check.SEQ, seed=0)
    batches = [{k: torch.from_numpy(np.asarray(v)) for k, v in r_global_batch_at(i, data).items()}
               for i in range(check.STEPS)]
    one_head = init_train_state(torch.Generator().manual_seed(0), check.config(1), device="cpu")
    return {"state": params_from_numpy(jax.tree.map(np.asarray, state), "cpu"), "batches": batches,
            "one_head": {"state": one_head, "batches": batches}}


def reference_steps(inputs: dict, microbatches: int):
    """The reference's single-device steps from the same state and batches:
    (each step's metrics, the parameters after the last) as numpy."""
    tcfg = rtrain.TrainConfig(optimizer=AdamWConfig(lr=1e-3), schedule=ScheduleConfig(warmup_steps=2, total_steps=50),
                              microbatches=microbatches)
    state = jax.tree.map(jnp.asarray, params_to_numpy(inputs["state"]))
    step = jax.jit(rtrain.make_train_step(reference_config(), tcfg))
    metrics = []
    for b in inputs["batches"]:
        state, m = step(state, {k: jnp.asarray(v.numpy()) for k, v in b.items()})
        metrics.append(jax.tree.map(np.asarray, m))
    return metrics, jax.tree.map(np.asarray, state["params"])


def _one_process(inputs: dict, tmp: Path) -> dict:
    """The one-process runs: the port's steps at ``microbatches`` 1 and 2,
    the reference's at 2, the launcher's run at ``--microbatches 2``."""
    one = {f"port.{k}": check.run(inputs, None, k)[:2] for k in (1, 2)}
    one["one_head"] = check.run(inputs["one_head"], None, cfg=check.config(1))[:2]
    one["reference"] = reference_steps(inputs, 2)
    keep = launch_train.get_smoke_config
    try:
        args = check.launch_args(check.LAUNCH_ONE + ["--microbatches", "2", "--ckpt-dir", str(tmp / "ckpt.one")])
        one["launch"] = launch_train.train(args, device=torch.device("cpu"), out=lambda *a: None)
    finally:
        launch_train.get_smoke_config = keep
    return one


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results and the one process's, from one spawn."""
    tmp = tmp_path_factory.mktemp("lm_seq_fsdp")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), str(REPO / "tests"), os.environ.get("PYTHONPATH", "")]))
    (tmp / "store").mkdir()
    procs, logs = [], []
    try:
        for r in range(check.WORLD):
            logs.append(open(tmp / f"rank{r}.log", "w"))
            procs.append(subprocess.Popen([sys.executable, str(REPO / "tests" / "lm_seq_fsdp_check.py"), str(r),
                                           str(check.WORLD), str(tmp / "store"), str(tmp), str(tmp / "inputs.pt")],
                                          env=env, stdout=logs[-1], stderr=subprocess.STDOUT, cwd=str(tmp)))
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        inputs = make_inputs()   # while the ranks start and form their groups
        torch.save(inputs, tmp / "inputs.part")
        os.replace(tmp / "inputs.part", tmp / "inputs.pt")
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


def _close_to_one_process(got: dict, want, what: str) -> None:
    """(ii)'s comparison: every metric within rtol 1e-5 (``tokens`` and
    ``accuracy`` exact), the state within check A's tolerances."""
    state, metrics = want
    assert len(got["metrics"]) == len(metrics) == check.STEPS
    for i, (g, w) in enumerate(zip(got["metrics"], metrics)):
        assert g.keys() == w.keys() and "moe_load_balance" in w
        for k in w:
            a, b = float(g[k]), float(w[k])
            if k in EXACT:
                assert a == b, (what, i, k, a, b)
            else:
                assert abs(a - b) <= METRIC_RTOL * max(abs(b), 1e-6), (what, i, k, a, b)
    _close_trees(got["state"]["params"], state["params"], what)
    _close_trees(got["state"]["opt"], state["opt"], f"{what}'s moments")


# -- (i), (ii), (iii): the step over the layouts ---------------------------------------------


def test_check_a_over_2x2_matches_the_reference(runs):
    got = _load(runs, "train.2x2")
    w_metrics, w_params = runs["one"]["reference"]
    for i, (m, w) in enumerate(zip(got["metrics"], w_metrics, strict=True)):
        loss, want = float(m["loss"]), float(w["loss"])
        assert abs(loss - want) / want < LOSS_RTOL, (i, loss, want)
    assert float(w_metrics[-1]["lr_scale"]) > 0
    _close_trees(got["state"]["params"], jax.tree.leaves(w_params), "2x2 against the reference")


@pytest.mark.parametrize("mesh", ONE_PROCESS)
def test_seq_fsdp_step_matches_one_process(runs, mesh):
    d, m = check.MESHES[mesh][:2]
    got = _load(runs, f"train.{mesh}")
    _close_to_one_process(got, runs["one"][f"port.{d}"], mesh)
    assert int(got["state"]["step"]) == check.STEPS
    # every model rank holds the same norm scales: their gradients are summed over the model ranks
    for r in range(d):
        held = [_load(runs, f"held.{mesh}.d{r}m{j}")["scales"] for j in range(m)]
        assert all(_equal_trees(held[0], h) for h in held[1:]), (mesh, r)
    # each boundary crossed every layer each step: the sequence gathered into the attention, the MoE layer and
    # the head, and scattered out of the first two, forward and again in the recompute (the head in neither
    # region), and each boundary's backward once; each norm's scale summed; each layer's fsdp leaves gathered
    # forward and again in the recompute, reduce-scattered once
    cfg = check.config()
    n, L = check.STEPS, cfg.total_layers
    model, data = got["counts"]["model"], got["counts"]["data"]
    assert model["seq_gather"] == n * (2 * 2 * L + 1) and model["seq_scatter"] == n * 2 * 2 * L
    assert model["seq_gather_grad"] == n * (2 * L + 1) and model["seq_scatter_grad"] == n * 2 * L
    assert model["seq_split_grad"] == n and model["norm_scale"] == n * (2 * L + 1)
    assert model["sum_out"] == 3 * n   # the embedding's and the loss's two over the vocabulary: no region's
    leaves = 8   # wq, wk, wv, wo; the router, w_gate, w_up, w_down
    assert data["param_gather"] == n * 2 * leaves * L and data["reduce_scatter"] == n * leaves * L


def test_whole_heads_under_the_sequence_split_match_one_process(runs):
    """One head over 2 model ranks: `rules_for` leaves it whole, so each
    rank runs the attention over the gathered sequence and keeps its block
    of the output (`seq_share` in, `seq_split` out)."""
    got = _load(runs, "one_head.1x2")
    _close_to_one_process(got, runs["one"]["one_head"], "one head over 1x2")
    counts, n, layers = got["counts"], check.STEPS, check.config(1).total_layers
    assert counts["seq_share"] >= n * 2 * layers and counts["seq_split_grad"] == n * (layers + 1)


def test_unsummed_norm_scale_gradients_fail_the_comparison(runs):
    with pytest.raises(AssertionError, match="grad_norm"):   # the first step's norm already counts a part
        _close_to_one_process(_load(runs, "mutation.1x2"), runs["one"]["port.1"], "mutation")


def test_fsdp_alone_matches_the_data_parallel_step(runs):
    got, want = _load(runs, "train.2x1"), _load(runs, "data.2x1")
    _close_to_one_process(got, (want["state"], want["metrics"]), "2x1")
    first, ref = got["metrics"][0], want["metrics"][0]
    assert all(torch.equal(first[k], ref[k]) for k in ref if k != "grad_norm")


def test_one_rank_is_the_one_process_step_bit_for_bit(runs):
    got = _load(runs, "train.1x1")
    state, metrics = runs["one"]["port.1"]
    assert _equal_trees(got["state"], state)
    assert all(a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
               for a, b in zip(got["metrics"], metrics, strict=True))


# -- (v), (vi): what a rank holds; checkpoints --------------------------------------------------


def test_each_rank_holds_its_slices_of_the_fsdp_leaves_and_moments(runs):
    cfg = check.config()
    table = rules_for(cfg, mode="train", multi_pod=False, data_axis=2, model_axis=2)
    whole = {n: tuple(t.shape) for n, t in _flatten_with_names(_load(runs, "train.2x2")["state"])}
    for d in range(2):
        for m in range(2):
            blocks = state_blocks(cfg, Rules(table, {"data": 2, "model": 2}, model=_Rank(m, 2), data=_Rank(d, 2)))
            held = _load(runs, f"held.2x2.d{d}m{m}")["shapes"]
            assert held.keys() == whole.keys()
            n_cut = 0
            for name, dd, md in zip(held, blocks.data_dims, blocks.dims, strict=True):
                want = list(whole[name])
                if dd is not None:
                    lo, hi = block_range(want[dd], 2, d)
                    want[dd] = hi - lo
                    assert hi - lo == whole[name][dd] // 2, name
                    n_cut += 1
                if md is not None:
                    want[md] = whole[name][md] // 2
                assert held[name] == tuple(want), (d, m, name, held[name], want)
            # wq, wk, wv, wo, router, w_gate, w_up, w_down of the stacked layers, in params, mu and nu
            assert n_cut == 3 * 8, n_cut


def test_checkpoint_over_2x2_resumes_over_2x2_and_1x1_bit_for_bit(runs):
    straight = _load(runs, "train.2x2")
    again = _load(runs, "resume.2x2")
    assert int(again["start"]["step"]) == check.SAVE_AT
    assert _equal_trees(again["state"], straight["state"])
    assert all(torch.equal(a["loss"], b["loss"]) for a, b in zip(again["metrics"], straight["metrics"][check.SAVE_AT:]))
    lone = _load(runs, "resume.1x1")
    assert _equal_trees(lone["start"], again["start"])
    start = check.restore(str(runs["dir"] / "ckpt.2x2"), None)
    assert _equal_trees(start, again["start"])
    state, metrics, *_ = check.run(runs["inputs"], None, state=start, first=check.SAVE_AT,
                                   steps=check.STEPS - check.SAVE_AT)
    assert _equal_trees(lone["state"], state)
    assert all(torch.equal(a["loss"], b["loss"]) for a, b in zip(lone["metrics"], metrics, strict=True))


# -- (vii): the launcher --------------------------------------------------------------------


def test_launch_train_runs_seq_and_fsdp_over_2x2(runs):
    got = _load(runs, "launch")
    want = runs["one"]["launch"]
    assert len(got["losses"]) == len(want) == check.STEPS
    for a, b in zip(got["losses"], want):
        assert abs(a - b) <= METRIC_RTOL * abs(b), (got["losses"], want)
    lines = "\n".join(got["lines"])
    assert "seq=model" in lines and "fsdp=('data',)" in lines and "restarts 0" in lines
    assert "model-axis collectives over 2 ranks:" in lines and "data-axis collectives over 2 ranks:" in lines
    assert "param_gather" in lines and "reduce_scatter" in lines


# -- (viii): the two-axis cut --------------------------------------------------------------------


class _Rank:
    """The block arithmetic of one axis's ranks at rank ``rank`` of
    ``world``, with no group."""

    def __init__(self, rank: int, world: int):
        self.rank, self.world = rank, world

    def range(self, n: int) -> tuple[int, int]:
        return block_range(n, self.world, self.rank)


@pytest.mark.parametrize("d,world_d,m,world_m", [(0, 3, 1, 2), (2, 3, 0, 3), (1, 2, 2, 3)])
def test_leaves_cut_over_both_axes(d, world_d, m, world_m):
    """deepseek's smoke leaves (d_model 64 over 3 data ranks: 22, 21 and
    21; 8 experts over 2 model ranks, each expert's width 48 over 3):
    ``wq`` cut along d_model on the data axis and its heads on the model
    axis; an expert matrix along its experts (or its width) on the model
    axis and d_model on the data axis; the norms whole; and the whole
    gathered back from every rank's blocks."""
    from repro_torch.configs.registry import get_smoke_config

    cfg = get_smoke_config("deepseek-moe-16b")
    table = rules_for(cfg, mode="train", multi_pod=False, data_axis=world_d, model_axis=world_m)
    rules = Rules(table, {"data": world_d, "model": world_m}, model=_Rank(m, world_m), data=_Rank(d, world_d))
    blocks = param_blocks(cfg, rules)
    whole = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    got, layer = blocks.cut(whole), whole["layers"][0]
    dlo, dhi = block_range(cfg.d_model, world_d, d)
    hlo, hhi = block_range(cfg.n_heads, world_m, m)
    assert torch.equal(got["layers"][0]["mixer"]["wq"], layer["mixer"]["wq"][:, dlo:dhi, hlo:hhi])
    assert torch.equal(got["layers"][0]["mixer"]["wo"], layer["mixer"]["wo"][:, hlo:hhi, :, dlo:dhi])
    ffn = got["layers"][0]["ffn"]
    if table["experts"] == "model":
        elo, ehi = block_range(cfg.moe.n_experts, world_m, m)
        assert torch.equal(ffn["w_gate"], layer["ffn"]["w_gate"][:, elo:ehi, dlo:dhi])
        assert torch.equal(ffn["w_down"], layer["ffn"]["w_down"][:, elo:ehi, :, dlo:dhi])
    else:
        flo, fhi = block_range(cfg.moe.d_expert, world_m, m)
        assert torch.equal(ffn["w_gate"], layer["ffn"]["w_gate"][:, :, dlo:dhi, flo:fhi])
        assert torch.equal(ffn["w_down"], layer["ffn"]["w_down"][:, :, flo:fhi, dlo:dhi])
    assert torch.equal(ffn["router"], layer["ffn"]["router"][:, dlo:dhi])
    assert torch.equal(got["layers"][0]["norm1"]["scale"], layer["norm1"]["scale"])
    assert torch.equal(got["embed"]["table"], whole["embed"]["table"][slice(*block_range(cfg.vocab_size, world_m, m))])
    # every rank's blocks, put back, are the whole (the checkpoint's gather, without the group)
    pieces = {(dd, mm): param_blocks(cfg, Rules(table, {}, model=_Rank(mm, world_m), data=_Rank(dd, world_d)))
              .cut(whole) for dd in range(world_d) for mm in range(world_m)}
    wq = torch.cat([torch.cat([pieces[dd, mm]["layers"][0]["mixer"]["wq"] for mm in range(world_m)], dim=2)
                    for dd in range(world_d)], dim=1)
    assert torch.equal(wq, layer["mixer"]["wq"])


class _OneRank(_Rank):
    """Both axes' gathers over a group of one, which keep the size of each
    piece they cross."""

    def __init__(self):
        super().__init__(0, 1)
        self.ranks, self.crossed = self, []

    def gather_dim(self, x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
        assert x.shape[dim] == n
        self.crossed.append(x.numel() * x.element_size())
        return x.clone()


def test_checkpoint_gather_crosses_a_chunk_at_a_time(monkeypatch):
    """A save's gather (`ModelBlocks.whole_leaves`) of deepseek's smoke
    state, with a chunk smaller than one period: each cut leaf crosses a
    period at a time along its stack axis, so no device holds more than a
    period of a whole leaf; the leaves come back whole on the host, bit for
    bit; a rank that does not keep them takes part in the same gathers."""
    import repro_torch.distributed.ranks as ranks_mod
    from repro_torch.configs.registry import get_smoke_config

    cfg = get_smoke_config("deepseek-moe-16b")
    monkeypatch.setattr(ranks_mod, "GATHER_CHUNK_BYTES", 64)
    table = rules_for(cfg, mode="train", multi_pod=False, data_axis=2, model_axis=2)
    model, data = _OneRank(), _OneRank()
    blocks = state_blocks(cfg, Rules(table, {}, model=model, data=data))
    state = init_train_state(torch.Generator().manual_seed(0), cfg, device="cpu")
    leaves = list(blocks.whole_leaves(state))
    assert all(w.device.type == "cpu" and torch.equal(w, t) for w, t in zip(leaves, tree_leaves(state), strict=True))
    fsdp_leaves = [t for t, d in zip(tree_leaves(state), blocks.data_dims, strict=True) if d is not None]
    assert fsdp_leaves and all(t.shape[0] == cfg.n_periods for t in fsdp_leaves)   # the layers' stacks
    assert len(data.crossed) == cfg.n_periods * len(fsdp_leaves)                    # a period a gather
    assert max(data.crossed) == max(t[0].numel() * t.element_size() for t in fsdp_leaves)
    seen = (len(model.crossed), len(data.crossed))
    assert list(blocks.whole_leaves(state, keep=False)) == [None] * len(leaves)
    assert (len(model.crossed), len(data.crossed)) == (2 * seen[0], 2 * seen[1])


def test_uneven_gather_and_reduce_scatter_over_3_ranks(runs):
    """Blocks of 3, 2, 2 (7 entries) and 2, 1, 1 (4): the gather is the
    whole, and each rank's reduce-scatter its block of the contributions
    summed in rank order (`stack_sum`), bit for bit, a row of the leading
    dimension a chunk."""
    whole, contrib = check.uneven_inputs()
    total = stack_sum(torch.stack(contrib))
    for r in range(3):
        got = _load(runs, f"uneven.r{r}")
        assert torch.equal(got["gather"], whole)
        lo, hi = block_range(7, 3, r)
        assert torch.equal(got["scatter1"], total[:, lo:hi])
        lo, hi = block_range(4, 3, r)
        assert torch.equal(got["scatter0"], total[lo:hi])
        assert got["chunks"] == 8   # 4 rows, twice
