"""Port parity of the language-model stack's logical-axis rules
(`repro_torch.distributed.sharding`), the dry-run cell table
(`repro_torch.launch.dryrun`) and ``launch.train --mesh`` against
`repro.distributed.sharding` and `repro.configs` on the CPU.

- The rule tables of `rules_for`, `train_rules` and `decode_rules` equal
  the reference's for every flag, and under them every parameter and
  decode-state spec equals ``tuple(P)`` of the reference, leaf by leaf and
  path by path, for the ten published configs.
- `use_rules` nests, restores after an exception and stays in its thread;
  `constrain` returns its tensor and refuses more axes than dims.
- With rules set the embedding backward skips its pre-sort (the
  reference's branch): the gradients stay bit-equal to those without.
- The dry run gives all 80 cells, the 12 ``long_500k`` skips with
  `cell_supported`'s reasons, and for the 68 others the reference's
  parameter counts, analytic costs and per-device argument bytes under
  its shardings; an uneven argument dim is replicated; the CLI caches.
- ``--mesh 2x2`` training prints the losses of the run without it.

`repro.launch.dryrun` is never imported here: at import it sets the XLA
flag that forces 512 host devices, which every later subprocess would
inherit. The reference's cells are built in a subprocess of their own.
"""

import itertools
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401
from jax.sharding import PartitionSpec as P  # noqa: E402

import repro.configs.registry as rreg  # noqa: E402
import repro.distributed.sharding as rsh  # noqa: E402
import repro_torch.configs.registry as treg  # noqa: E402
import repro_torch.distributed.sharding as tsh  # noqa: E402
from repro.models import transformer as rtr  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import cross_entropy, forward, init_params  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.common import embed_lookup  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from repro_torch.train import TrainConfig, init_train_state, make_train_step  # noqa: E402
from test_torch_models import port_config  # noqa: E402
from test_training import TINY  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list(rreg.ARCH_IDS)
MESHES = [(16, 16), (2, 2), (1, 4)]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_specs(tree) -> dict:
    """path -> tuple(P) of a reference specs tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path): tuple(spec) for path, spec in flat}


def port_specs(tree, path=()) -> dict:
    """path -> spec of a port specs tree (the same leaf test as `tree_specs`)."""
    if isinstance(tree, tuple) and not any(isinstance(t, dict) for t in tree):
        return {path: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(port_specs(v, path + (k,)))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_rules_for_and_every_spec_match_reference(arch):
    rcfg, tcfg = rreg.get_config(arch), treg.get_config(arch)
    r_axes = {"params": rtr.param_axes(rcfg), "decode": rtr.decode_state_axes(rcfg)}
    t_axes = {"params": ttr.param_axes(tcfg), "decode": ttr.decode_state_axes(tcfg)}
    for mode, multi_pod, shard_batch, (d, m) in itertools.product(("train", "decode"), (False, True), (True, False),
                                                                  MESHES):
        kw = dict(mode=mode, multi_pod=multi_pod, data_axis=d, model_axis=m, shard_batch=shard_batch)
        table = tsh.rules_for(tcfg, **kw)
        assert table == rsh.rules_for(rcfg, **kw), kw
        want = ref_specs(rsh.tree_specs(r_axes, rsh.Rules(rsh.rules_for(rcfg, **kw))))
        got = port_specs(tsh.tree_specs(t_axes, tsh.Rules(table)))
        assert got == want, kw


def test_fixed_rule_tables_and_spec_form_match_reference():
    for multi_pod, ep in itertools.product((False, True), (False, True)):
        assert tsh.train_rules(multi_pod, expert_parallel=ep) == rsh.train_rules(multi_pod, expert_parallel=ep)
        for sb in (True, False):
            assert (tsh.decode_rules(multi_pod, shard_batch=sb, expert_parallel=ep)
                    == rsh.decode_rules(multi_pod, shard_batch=sb, expert_parallel=ep))
    table = {"a": ("data",), "b": ("pod", "data"), "c": "model", "d": (), "e": None}
    axes = ("a", "b", "c", "d", "e", None, "missing")
    assert tsh.Rules(table).spec(axes) == tuple(rsh.Rules(table).spec(axes))
    assert tsh.Rules(table).spec(()) == tuple(rsh.Rules(table).spec(())) == ()
    # the empty tuple is a leaf (a scalar's axes), as in the reference
    tree = {"count": (), "w": ("a", None), "layers": ({"x": ("c",)},)}
    assert port_specs(tsh.tree_specs(tree, tsh.Rules(table))) == ref_specs(rsh.tree_specs(tree, rsh.Rules(table)))
    assert tsh.Rules(table, {"data": 2, "model": 2}).mesh == {"data": 2, "model": 2}


def test_use_rules_nests_restores_and_stays_in_its_thread():
    outer, inner = tsh.Rules({"batch": "data"}), tsh.Rules({"batch": None})
    assert tsh.current_rules() is None and tsh.logical_spec(("batch",)) is None
    with tsh.use_rules(outer):
        assert tsh.current_rules() is outer
        with tsh.use_rules(inner):
            assert tsh.current_rules() is inner and tsh.logical_spec(("batch",)) == (None,)
        assert tsh.current_rules() is outer and tsh.logical_spec(("batch", None)) == ("data", None)
        with pytest.raises(RuntimeError), tsh.use_rules(inner):
            raise RuntimeError("inside")
        assert tsh.current_rules() is outer
        seen = []
        t = threading.Thread(target=lambda: seen.append(tsh.current_rules()))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive() and seen == [None]
    assert tsh.current_rules() is None


def test_constrain_returns_its_tensor_and_refuses_too_many_axes():
    x = torch.zeros(2, 3)
    assert tsh.constrain(x, "batch", "seq", "embed") is x       # no rules: nothing is checked
    with tsh.use_rules(tsh.Rules(tsh.train_rules(False))):
        assert tsh.constrain(x, "batch", "embed") is x
        assert tsh.constrain(x, "batch") is x                   # fewer axes: the rest replicated
        with pytest.raises(ValueError, match="rank 2"):
            tsh.constrain(x, "batch", "seq", "embed")


def test_every_smoke_config_runs_under_rules():
    """Every `constrain` call site of forward and decode passes the rank
    check (the reference's `with_sharding_constraint` would refuse one)."""
    for arch in ARCHS:
        cfg = treg.get_smoke_config(arch)
        params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
        toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(1))
        kw, enc = {}, None
        if cfg.encoder_layers:
            kw["frames"] = torch.randn(2, cfg.encoder_frames, cfg.d_model)
            enc = ttr.encode(params, kw["frames"], cfg)
        if cfg.prefix_tokens:
            kw["prefix_embeddings"] = torch.randn(2, cfg.prefix_tokens, cfg.d_model)
        with torch.no_grad():
            with tsh.use_rules(tsh.Rules(tsh.rules_for(cfg, mode="train", multi_pod=False, data_axis=2,
                                                       model_axis=2))):
                want = forward(params, toks, cfg, **kw)
            assert torch.equal(want, forward(params, toks, cfg, **kw)), arch
            with tsh.use_rules(tsh.Rules(tsh.rules_for(cfg, mode="decode", multi_pod=True, shard_batch=False))):
                state = ttr.init_decode_state(cfg, 2, 16, cfg.dtype, device="cpu")
                _, state = ttr.decode_step(params, state, toks[:, :4], cfg, enc_out=enc)
                logits, _ = ttr.decode_step(params, state, toks[:, 4:5], cfg, enc_out=enc)
        assert bool(torch.isfinite(logits).all()), arch


def test_embedding_backward_under_rules_is_bit_equal():
    """With rules set the embedding backward adds its rows unsorted (the
    reference skips the pre-sort there); the train-step gradients of
    ``tiny`` stay the same bits."""
    cfg = port_config(TINY)
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    leaves = tree_leaves(params)
    gen = torch.Generator().manual_seed(3)
    inputs = torch.randint(0, cfg.vocab_size, (8, 32), generator=gen)
    targets = torch.randint(0, cfg.vocab_size, (8, 32), generator=gen)
    assert len(torch.unique(inputs)) < inputs.numel() // 4       # ids repeat

    def grads():
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = cross_entropy(forward(params, inputs, cfg), targets)
        return torch.autograd.grad(loss, leaves)

    plain = grads()
    with tsh.use_rules(tsh.Rules(tsh.train_rules(False))):
        ruled = grads()
    assert float(plain[0].abs().max()) > 0
    for a, b in zip(plain, ruled):
        assert torch.equal(a, b)
    # one train step (aux and z-loss terms, clip, AdamW) from the same state
    step = make_train_step(cfg, TrainConfig())
    batch = {"inputs": inputs, "targets": targets}
    states = []
    for rules in (None, tsh.Rules(tsh.train_rules(False))):
        state = init_train_state(torch.Generator().manual_seed(0), cfg, device="cpu")
        with tsh.use_rules(rules):
            state, _ = step(state, batch)
        states.append(tree_leaves(state))
    assert all(torch.equal(a, b) for a, b in zip(*states))


@pytest.mark.parametrize("ruled", [False, True])
def test_embedding_backward_sorts_as_its_forward_decided(ruled, monkeypatch):
    """The pre-sort is decided where the lookup ran. A card runs the
    backward on autograd's own worker thread, which holds no rule table;
    here the backward runs on a thread of its own, as there."""
    sorts = []
    argsort = torch.argsort
    monkeypatch.setattr(torch, "argsort", lambda *a, **k: sorts.append(1) or argsort(*a, **k))
    gen = torch.Generator().manual_seed(5)
    table = torch.randn((16, 4), generator=gen).requires_grad_(True)
    ids = torch.tensor([[3, 1, 3, 0], [1, 3, 9, 0]])
    with tsh.use_rules(tsh.Rules(tsh.train_rules(False)) if ruled else None):
        y = embed_lookup(table, ids)
    g = torch.randn(y.shape, generator=gen)
    grads = []
    worker = threading.Thread(target=lambda: grads.append(torch.autograd.grad(y, table, g)[0]))
    worker.start()
    worker.join()
    assert len(sorts) == (0 if ruled else 1)
    assert torch.equal(grads[0], torch.zeros(16, 4).index_add_(0, ids.reshape(-1), g.reshape(-1, 4)))


# ---------------------------------------------------------------------------
# the dry-run cell table
# ---------------------------------------------------------------------------


# The reference's side of the cell table, run in a subprocess (its import
# forces 512 host devices): `build_cell`'s argument shardings for every
# supported cell, summed at each argument's shard shape, and `cell_costs`.
# Nothing is lowered or compiled. `jax.eval_shape` is memoised on the traced
# function's code and closure, so each architecture's state shapes are
# traced once and not once a cell.
_REFERENCE_CELLS = """
import json, math, sys
from repro.launch import dryrun
import jax
import numpy as np
from repro.configs.registry import ARCH_IDS, SHAPES, cell_supported
from repro.launch.flops import cell_costs

_eval_shape, _memo = jax.eval_shape, {}

def eval_shape(fn, *args):
    key = (fn.__code__, tuple(c.cell_contents for c in fn.__closure__ or ()),
           tuple((a.shape, str(a.dtype)) for a in args))
    if key not in _memo:
        _memo[key] = _eval_shape(fn, *args)
    return _memo[key]

jax.eval_shape = eval_shape
out = {}
for arch in ARCH_IDS:
    for shape in SHAPES:
        if not cell_supported(arch, shape)[0]:
            continue
        for multi_pod in (False, True):
            _, args, shs, _, mesh, cfg = dryrun.build_cell(arch, shape, multi_pod=multi_pod)
            nbytes = sum(math.prod(sh.shard_shape(a.shape)) * np.dtype(a.dtype).itemsize
                         for a, sh in zip(jax.tree.leaves(args), jax.tree.leaves(shs), strict=True))
            costs = cell_costs(cfg, SHAPES[shape], mesh.size)
            out[f"{arch}/{shape}/{int(multi_pod)}"] = [nbytes, costs["flops"], costs["bytes"]]
json.dump(out, sys.stdout)
"""


def test_dryrun_gives_every_cell_with_the_reference_counts():
    """All 80 cells, the 12 skips with `cell_supported`'s reasons, and for
    each of the 68 others the reference's parameter count, its analytic
    costs and the bytes of its arguments' shards on the production mesh."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE_CELLS], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    cells = [(a, s, m) for a in ARCHS for s in treg.SHAPES for m in (False, True)]
    records = [dryrun.run_cell(a, s, multi_pod=m) for a, s, m in cells]
    params_b = {a: rreg.get_config(a).param_count() / 1e9 for a in ARCHS}
    out, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-2000:]
    want = json.loads(out)
    assert len(records) == 80 and len(want) == 68
    assert sum("skipped" in r for r in records) == 12
    for (a, s, m), r in zip(cells, records):
        ok, reason = rreg.cell_supported(a, s)
        assert (r["arch"], r["shape"], r["mesh"]) == (a, s, "pod2x16x16" if m else "pod16x16")
        if not ok:
            assert r == {"arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"], "skipped": reason}
            continue
        got = [r["argument_size_in_bytes"], r["flops"], r["bytes_accessed"]]
        assert got == want[f"{a}/{s}/{int(m)}"], (a, s, m)
        assert r["params_b"] == params_b[a]


def test_dryrun_replicates_uneven_argument_dims():
    """starcoder2-7b's 36 heads are sharded in the rule table (GSPMD pads
    them inside the step) but not as an argument on a 16-way axis."""
    _, (state, _), (state_sh, batch_sh), rules, mesh, cfg = dryrun.build_cell("starcoder2-7b", "train_4k",
                                                                                multi_pod=False)
    assert cfg.n_heads == 36 and rules.table["heads"] == "model" and mesh == {"data": 16, "model": 16}
    wq = state_sh["params"]["layers"][0]["mixer"]["wq"]       # ("stack", "fsdp", "heads", None)
    assert wq.spec == (None, "data", None, None)
    mlp = state_sh["params"]["layers"][0]["ffn"]
    assert any("model" in sh.spec for sh in tree_leaves(mlp))
    assert batch_sh["inputs"].spec == ("data", None)
    n = state["params"]["layers"][0]["mixer"]["wq"]
    assert wq.device_bytes(n) == n.numel() * 2 // 16


def test_dryrun_cli_writes_a_cell_and_skips_it_when_cached(tmp_path, capsys):
    argv = ["--arch", "phi3-mini-3.8b", "--shape", "train_4k", "--mesh", "single", "--out", str(tmp_path)]
    dryrun.main(argv)
    files = list(tmp_path.iterdir())
    assert [f.name for f in files] == ["phi3-mini-3.8b__train_4k__pod16x16.json"]
    record = json.loads(files[0].read_text())
    assert record == dryrun.run_cell("phi3-mini-3.8b", "train_4k", multi_pod=False)
    assert "[ok] phi3-mini-3.8b x train_4k x pod16x16" in capsys.readouterr().out
    dryrun.main(argv)
    assert "[skip cached]" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# launch.train --mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", ["2x2", "2"])
def test_train_launcher_mesh_gives_the_losses_of_the_run_without(mesh, tmp_path, capsys):
    argv = ["--arch", "phi3-mini-3.8b", "--smoke", "--steps", "4", "--global-batch", "4", "--seq", "16",
            "--device", "cpu", "--ckpt-dir", str(tmp_path / "a")]
    tlaunch.main(argv)
    plain = capsys.readouterr().out.splitlines()
    tlaunch.main(argv[:-1] + [str(tmp_path / "b"), "--mesh", mesh])
    ruled = capsys.readouterr().out.splitlines()
    sizes = dict(zip(("data", "model"), (int(x) for x in mesh.split("x"))))
    assert ruled[0].startswith(f"mesh {sizes}: rules batch=('data',), ")
    losses = lambda line: line.split("losses ")[1].split(";")[0]  # noqa: E731
    assert losses(ruled[1]) == losses(plain[0])
    assert np.all(np.isfinite([float(x) for x in losses(plain[0]).split()]))
