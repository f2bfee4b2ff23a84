"""Port parity of the LM train step (`repro_torch.train`, the in-place
`optim.adamw_update_`, the deterministic embedding and MoE-dispatch
backwards) against `repro.train` on the CPU.

Both packages start from the reference's train state
(`repro.train.init_train_state`, carried over with `params_from_numpy`) and
take the same batches (`repro.data.global_batch_at`, or
tests/test_arch_smoke.py's `_batch`, as numpy). The reference's step runs
under `jax.jit`.

- ``tiny`` and ``tiny_moe`` (tests/test_training.py's configs), with one
  and two microbatches: two steps. The first runs at ``lr_scale`` 0 (the
  warm-up's first step), so it compares the clipped gradients through the
  first moment (``mu = 0.1 g``) and the second (``nu = 0.05 g^2``), and
  leaves the parameters as they were, exactly; the second moves the
  parameters by Adam steps. Caution: on an early Adam step the update is
  about ``lr * sign(g)`` wherever ``|g| >> eps``, so a gradient near 0 can
  flip sign between the two packages. The parameters are held to within
  ``2 lr`` of the reference's everywhere, and to 1e-4 of each leaf's
  largest magnitude at all but 0.5% of the elements.
- every architecture's ``smoke_config()``, one step of
  test_arch_smoke.py's `test_smoke_train_step`;
- the loss falls on the port's own data, as in tests/test_training.py;
- `adamw_update_` bit-equal to `adamw_update`;
- the embedding's and the MoE dispatch's backwards equal to the atomic
  routes they replace (``index_add_``, `torch.gather`'s own backward)
  within float32 rounding.

Tolerances: the metrics (loss, accuracy, grad norm, the MoE metrics,
``lr_scale``) within rtol 1e-5; the moments within 1e-4 x max|reference|
per leaf (float32, different summation orders); the counters exact.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.configs.registry as rreg  # noqa: E402
import repro.data as rdata  # noqa: E402
import repro.train as rtrain  # noqa: E402
import repro_torch.configs.registry as treg  # noqa: E402
import repro_torch.data as tdata  # noqa: E402
import repro_torch.train as ttrain  # noqa: E402
from repro.models import LayerSpec, ModelConfig, MoEConfig  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from test_arch_smoke import TCFG as SMOKE_TCFG  # noqa: E402
from test_arch_smoke import _batch as smoke_batch  # noqa: E402
from test_torch_models import assert_trees, close, port_config, to_port  # noqa: E402
from test_training import DATA, TCFG, TINY  # noqa: E402

TINY_MOE = ModelConfig(
    name="tiny_moe", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
    vocab_size=64, pattern=(LayerSpec("attn", "moe"),),
    moe=MoEConfig(n_experts=4, top_k=2, capacity_factor=2.0),
)
CONFIGS = {"tiny": TINY, "tiny_moe": TINY_MOE}
METRIC_RTOL = 1e-5
REL = 1e-4
STRAY_SHARE = 5e-3  # elements of a leaf allowed beyond REL after an Adam step (sign flips near g = 0)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_train_config(tcfg, **kw):
    return ttrain.TrainConfig(
        optimizer=toptim.AdamWConfig(**dataclasses.asdict(tcfg.optimizer)),
        schedule=toptim.ScheduleConfig(**dataclasses.asdict(tcfg.schedule)),
        moe_aux_weight=tcfg.moe_aux_weight, z_loss=tcfg.z_loss, microbatches=tcfg.microbatches, **kw)


def to_port_batch(batch) -> dict:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32 if np.asarray(v).dtype.kind == "f" else None))
            for k, v in batch.items()}


def assert_metrics(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want), (what, sorted(got), sorted(want))
    for k, w in want.items():
        g, w = float(got[k]), float(np.asarray(w))
        assert abs(g - w) <= METRIC_RTOL * max(abs(w), 1e-6), f"{what} {k}: {g!r} against {w!r}"


def assert_params_after_adam(got, want, lr: float, path="") -> None:
    """Each leaf within ``2 lr`` of the reference's everywhere, and within
    REL x its largest magnitude at all but STRAY_SHARE of its elements."""
    if isinstance(want, dict):
        for k in want:
            assert_params_after_adam(got[k], want[k], lr, f"{path}/{k}")
        return
    if isinstance(want, (tuple, list)):
        for i, (g, w) in enumerate(zip(got, want)):
            assert_params_after_adam(g, w, lr, f"{path}/{i}")
        return
    w = np.asarray(want, np.float64)
    g = got.double().numpy()
    diff = np.abs(g - w)
    assert diff.max() <= 2 * lr * (1 + 1e-4), (path, diff.max(), lr)
    stray = np.mean(diff > REL * np.max(np.abs(w)))
    assert stray <= STRAY_SHARE, (path, stray)


def _run_reference(cfg, tcfg, batches):
    state = rtrain.init_train_state(jax.random.PRNGKey(0), cfg)
    start = to_port(state)
    step = jax.jit(rtrain.make_train_step(cfg, tcfg))
    out = []
    for b in batches:
        state, m = step(state, b)
        out.append((jax.tree.map(np.asarray, state), jax.tree.map(np.asarray, m)))
    return start, out


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_train_step_matches_reference(name, microbatches):
    cfg = CONFIGS[name]
    tcfg = dataclasses.replace(TCFG, microbatches=microbatches)
    batches = [rdata.global_batch_at(i, DATA) for i in range(2)]
    state, want = _run_reference(cfg, tcfg, batches)
    step = ttrain.make_train_step(port_config(cfg), port_train_config(tcfg))
    params0 = tcommon.tree_map(torch.clone, state["params"])

    state, m = step(state, to_port_batch(batches[0]))
    (w_state, w_m) = want[0]
    assert_metrics(m, w_m, f"{name} step 1")
    if cfg.moe is not None:
        assert "moe_load_balance" in m and "moe_dropped_frac" in m
    assert float(m["lr_scale"]) == 0.0
    assert int(state["step"]) == 1 and int(state["opt"]["count"]) == 1
    assert_trees(state["opt"]["mu"], w_state["opt"]["mu"], REL, "mu")  # 0.1 x the clipped gradient
    assert_trees(state["opt"]["nu"], w_state["opt"]["nu"], REL, "nu")
    # lr_scale 0: the parameters are what they were, in both packages
    assert all(torch.equal(a, b) for a, b in zip(tcommon.tree_leaves(state["params"]),
                                                   tcommon.tree_leaves(params0)))
    assert_trees(state["params"], w_state["params"], 0.0, "params")

    state, m = step(state, to_port_batch(batches[1]))
    (w_state, w_m) = want[1]
    assert_metrics(m, w_m, f"{name} step 2")
    assert int(state["step"]) == 2
    lr = tcfg.optimizer.lr * float(w_m["lr_scale"])
    assert lr > 0
    assert_params_after_adam(state["params"], w_state["params"], lr)


@pytest.mark.slow
@pytest.mark.parametrize("arch", list(rreg.ARCH_IDS))
def test_smoke_train_step_matches_reference(arch):
    """tests/test_arch_smoke.py's one train step of each smoke config (lr
    scale 0 on the first step: the moments carry the gradients)."""
    cfg = rreg.get_smoke_config(arch)
    batch = smoke_batch(cfg)
    state, [(w_state, w_m)] = _run_reference(cfg, SMOKE_TCFG, [batch])
    step = ttrain.make_train_step(treg.get_smoke_config(arch), port_train_config(SMOKE_TCFG))
    state, m = step(state, to_port_batch(batch))
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    assert int(state["step"]) == 1
    assert_metrics(m, w_m, arch)
    assert_trees(state["opt"], w_state["opt"], REL, "opt")
    assert_trees(state["params"], w_state["params"], 0.0, "params")


@pytest.mark.parametrize("name,n_steps,ratio", [("tiny", 30, 0.8), ("tiny_moe", 25, 0.9)])
def test_training_reduces_loss(name, n_steps, ratio):
    """tests/test_training.py's convergence checks on the port's own data
    and its own initial parameters."""
    cfg = port_config(CONFIGS[name])
    state = ttrain.init_train_state(torch.Generator().manual_seed(0), cfg, device="cpu")
    step = ttrain.make_train_step(cfg, port_train_config(TCFG))
    data = tdata.DataConfig(vocab_size=64, global_batch=8, seq_len=32, seed=0)
    losses = []
    for i in range(n_steps):
        state, m = step(state, tdata.global_batch_at(i, data, device="cpu"))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * ratio, losses[::5]
    if cfg.moe is not None:
        assert "moe_load_balance" in m


def test_adamw_update_inplace_is_bit_equal_to_functional(monkeypatch):
    """Three steps of `adamw_update_`, its leaves cut into slices of 7
    elements, against `adamw_update` (the same update on copies, whole
    leaves at a time) on a tree of dicts and tuples with float32 and
    bfloat16 leaves, a strided gradient and a clip that bites. The
    functional update leaves its inputs as they were."""
    whole = tadamw._CHUNK
    gen = torch.Generator().manual_seed(3)
    params = {"a": torch.randn(5, 6, generator=gen),
              "layers": ({"w": torch.randn(3, 4, 5, generator=gen).to(torch.bfloat16)},
                         {"w": torch.randn(3, 4, 5, generator=gen)}),
              "s": torch.randn((), generator=gen)}
    cfg = toptim.AdamWConfig(lr=1e-2, grad_clip=0.5)
    live = tcommon.tree_map(torch.clone, params)
    state_f = toptim.adamw_init(params)
    state_i = toptim.adamw_init(live)
    for i in range(3):
        grads = tcommon.tree_map(lambda p: 3 * torch.randn(p.shape, generator=gen).to(p.dtype), params)
        grads["a"] = torch.randn(6, 5, generator=gen).t()  # strided, as autograd may give it
        scale = toptim.lr_schedule(torch.tensor(i + 1, dtype=torch.int32), toptim.ScheduleConfig(warmup_steps=2))
        inputs = (params, state_f)
        before = tcommon.tree_map(torch.clone, inputs)
        monkeypatch.setattr(tadamw, "_CHUNK", whole)
        params, state_f, m_f = toptim.adamw_update(grads, state_f, params, cfg, lr_scale=scale)
        for x, y in zip(tcommon.tree_leaves(inputs), tcommon.tree_leaves(before)):
            assert torch.equal(x, y)
        monkeypatch.setattr(tadamw, "_CHUNK", 7)
        m_i = toptim.adamw_update_(grads, state_i, live, cfg, lr_scale=scale)
        assert torch.equal(m_i["grad_norm"], m_f["grad_norm"])
        assert torch.equal(state_i["count"], state_f["count"])
        for tree_i, tree_f in ((live, params), (state_i["mu"], state_f["mu"]), (state_i["nu"], state_f["nu"])):
            for x, y in zip(tcommon.tree_leaves(tree_i), tcommon.tree_leaves(tree_f)):
                assert x.dtype == y.dtype and torch.equal(x, y)


def _atomic_embed_grad(ids, g, v):
    """The route the embedding's backward replaced: the sorted rows added
    with ``index_add_`` (atomics on a card)."""
    flat_ids = ids.reshape(-1)
    order = torch.argsort(flat_ids, stable=True)
    dt = torch.zeros((v, g.shape[-1]), dtype=torch.float32)
    dt.index_add_(0, flat_ids[order], g.reshape(-1, g.shape[-1])[order].float())
    return dt


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_backward_matches_atomic_route(dtype):
    gen = torch.Generator().manual_seed(5)
    v, d = 40, 16
    table = torch.randn(v, d, generator=gen).to(dtype).requires_grad_(True)
    ids = (torch.randn(6, 50, generator=gen).abs() * 6).long().clamp_max(v - 1)  # repeated ids, skewed
    g = torch.randn(6, 50, d, generator=gen).to(dtype)
    (got,) = torch.autograd.grad(tcommon.embed_lookup(table, ids), table, g)
    want = _atomic_embed_grad(ids, g, v).to(dtype)
    assert got.dtype == dtype
    close(got.float(), want.float().numpy(), 1e-6, what="embedding backward vs index_add_")


@pytest.mark.parametrize("capacity_factor", [0.5, 2.0])
def test_dispatch_gather_backward_matches_atomic_route(capacity_factor):
    """The dispatch gather's backward (each token's k slots added in k
    order) against `torch.gather`'s (a scatter-add over the slots), with
    gap slots and, at capacity factor 0.5, dropped assignments."""
    gen = torch.Generator().manual_seed(6)
    b, s, d, e, k = 2, 24, 8, 4, 3
    cap = tmoe._capacity(s, tcommon.MoEConfig(n_experts=e, top_k=k, capacity_factor=capacity_factor))
    ids = torch.stack([torch.randperm(e, generator=gen)[:k] for _ in range(b * s)]).reshape(b, s, k)
    slot_token, a_slot, fits = tmoe._dispatch_row(ids, n_experts=e, cap=cap, s=s, k=k)
    assert bool((slot_token == s).any())  # gap slots
    if capacity_factor < 1:
        assert not bool(fits.all())  # dropped assignments
    x = torch.randn(b, s, d, generator=gen, requires_grad=True)
    cot = torch.randn(b, e * cap, d, generator=gen)
    buf = tmoe._DispatchGather.apply(x, slot_token, a_slot, k)
    x_ext = torch.cat([x, x.new_zeros((b, 1, d))], dim=1)
    plain = torch.gather(x_ext, 1, slot_token.long()[..., None].expand(b, e * cap, d))
    assert torch.equal(buf, plain)
    (got,) = torch.autograd.grad(buf, x, cot)
    (want,) = torch.autograd.grad(plain, x, cot)
    close(got, want.numpy(), 1e-6, what="dispatch backward vs torch.gather's")
