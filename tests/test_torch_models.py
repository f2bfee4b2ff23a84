"""Port parity of the language-model stack (`repro_torch.models`) against
`repro.models` on the CPU.

Both packages get the same numbers: the reference's parameters
(`repro.models.init_params`) carried over with `params_from_numpy`, tokens
and frames made with numpy from a seed. The reference runs under
`jax.jit`, one compile per shape.

- every family of tests/test_models.py: forward logits; the gradient of
  `cross_entropy(forward(...))` for every parameter leaf; 16 one-token
  decode steps from the carried decode state, the logits at each step and
  the final state; the port's decode against the port's forward;
- the flash attention against the dense one and the reference's, forward
  and vjp, and `gradcheck` of its `Function` in float64;
- the MoE dispatch indices, `moe_apply` with no drops and with drops, and
  the naive per-token expert loop;
- the embedding's sorted-scatter backward;
- a block prefill against stepwise decode, and the clamped ring-cache write.

Tolerances: floats within 1e-4 x max|reference| per tensor (float32,
different summation orders); the port's decode against its own forward
within 2e-5 of the largest logit (the reference's gate); index structures,
the dropped fraction, the decode state's ``index`` and cache ``pos``
exact.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models as rm  # noqa: E402
import repro_torch.models as tm  # noqa: E402
from repro.models import attention as rattn  # noqa: E402
from repro.models import common as rcommon  # noqa: E402
from repro.models import moe as rmoe  # noqa: E402
from repro.models import transformer as rtr  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from test_models import FAMILIES  # noqa: E402

REL = 1e-4          # port vs reference, float32
SELF_REL = 2e-5     # the port's decode vs its own forward (the reference's gate)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- conversions and comparisons --------------------------------------------------------

def torch_dtype(dt) -> torch.dtype:
    """The torch dtype of a JAX or numpy dtype of the same name."""
    return getattr(torch, np.dtype(dt).name)


def port_config(cfg):
    """The port's `ModelConfig` with the same fields as the reference's
    ``cfg``, dtypes mapped."""
    moe = tcommon.MoEConfig(**dataclasses.asdict(cfg.moe)) if cfg.moe is not None else None
    spec = lambda ls: tuple(tcommon.LayerSpec(**dataclasses.asdict(s)) for s in ls)  # noqa: E731
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields.update(pattern=spec(cfg.pattern), tail=spec(cfg.tail), moe=moe, dtype=torch_dtype(cfg.dtype))
    return tcommon.ModelConfig(**fields)


def ref_params(cfg, seed: int):
    """The reference's parameters of ``cfg`` from ``PRNGKey(seed)`` (eager:
    across a file's configs its op cache makes that cheaper than a compile
    per config)."""
    return rm.init_params(jax.random.PRNGKey(seed), cfg)


def to_port(tree):
    """A reference tree (params, decode state) as the port's, on the CPU."""
    return tm.params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def close(got, want, rel=REL, what=""):
    """max|got - want| <= rel * max|want|; returns the relative error."""
    want = np.asarray(want, np.float64)
    got = got.detach().cpu().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.all(np.isfinite(got)), what
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= rel * scale, f"{what}: max |diff| {err:.3e} against {rel} x {scale:.3e}"
    return err / max(scale, 1e-30)


def assert_trees(got, want, rel=REL, path="") -> None:
    """Every leaf of the port's tree against the reference's: float leaves
    within ``rel`` of their largest magnitude, int and bool leaves exact."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_trees(got[k], want[k], rel, f"{path}/{k}")
        return
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees(g, w, rel, f"{path}/{i}")
        return
    w = np.asarray(want)
    if np.issubdtype(w.dtype, np.integer) or w.dtype == np.bool_:
        np.testing.assert_array_equal(got.cpu().numpy(), w, err_msg=path)
    else:
        close(got, w, rel, path)


def _tokens(rng, cfg, b, s):
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _frames(rng, cfg, b, f=8):
    return rng.standard_normal((b, f, cfg.d_model)).astype(np.float32) if cfg.encoder_layers else None


# -- every family of tests/test_models.py --------------------------------------------------


def _ref_loss_and_grads(cfg):
    def loss_fn(p, toks, frames):
        logits = rm.forward(p, toks, cfg, frames=frames)
        return rm.cross_entropy(logits, toks)[0], logits

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_forward_and_grads_match_reference(family):
    """Logits, loss and every parameter's gradient against `jax.grad` of the
    reference, with remat on in both."""
    cfg = FAMILIES[family]
    tcfg = port_config(cfg)
    rng = np.random.default_rng(10)
    toks = _tokens(rng, cfg, 2, 16)
    frames = _frames(rng, cfg, 2)
    rparams = ref_params(cfg, 0)
    (rloss, rlogits), rgrads = _ref_loss_and_grads(cfg)(rparams, toks, frames)

    params = to_port(rparams)
    for leaf in tcommon.tree_leaves(params):
        leaf.requires_grad_(True)
    t_toks = torch.from_numpy(toks)
    logits = tm.forward(params, t_toks, tcfg, frames=None if frames is None else torch.from_numpy(frames))
    loss, _ = tm.cross_entropy(logits, t_toks)
    loss.backward()
    close(logits, rlogits, what="logits")
    close(loss, rloss, what="loss")
    assert_trees(tcommon.tree_map(lambda t: t.grad, params), rgrads, path="grad")


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_decode_matches_reference_and_own_forward(family):
    """16 one-token steps from the carried decode state: the logits of each
    step and the final state against the reference's; each step's logits
    against the port's own forward at that position."""
    cfg = FAMILIES[family]
    tcfg = port_config(cfg)
    rng = np.random.default_rng(11)
    b, s = 2, 16
    toks = _tokens(rng, cfg, b, s)
    frames = _frames(rng, cfg, b)
    rparams = ref_params(cfg, 1)
    params = to_port(rparams)

    r_enc = jax.jit(lambda p, f: rtr.encode(p, f, cfg))(rparams, frames) if frames is not None else None
    r_step = jax.jit(lambda p, st, t, e: rm.decode_step(p, st, t, cfg, enc_out=e))
    enc = None if frames is None else tm.encode(params, torch.from_numpy(frames), tcfg)
    if frames is not None:
        close(enc, r_enc, what="enc_out")

    r_st = rm.init_decode_state(cfg, b, s + 4, jnp.float32)
    st = tm.init_decode_state(tcfg, b, s + 4, torch.float32, device="cpu")
    assert_trees(st, r_st, path="state0")
    with torch.no_grad():
        fwd = tm.forward(params, torch.from_numpy(toks), tcfg, remat=False,
                         frames=None if frames is None else torch.from_numpy(frames))
        for t in range(s):
            r_lg, r_st = r_step(rparams, r_st, toks[:, t:t + 1], r_enc)
            lg, st = tm.decode_step(params, st, torch.from_numpy(toks[:, t:t + 1]), tcfg, enc_out=enc)
            close(lg, r_lg, what=f"step {t}")
            close(lg[:, 0], fwd[:, t].numpy(), SELF_REL, what=f"decode vs forward at {t}")
    assert_trees(st, r_st, path="state")
    assert int(st["index"]) == s


# -- flash attention -----------------------------------------------------------------


@pytest.mark.parametrize("causal,window", [(True, None), (True, 8), (False, None)])
def test_chunked_attention_matches_dense_and_reference(causal, window):
    """Forward and vjp of the flash `Function` at chunks of 16 over 64
    positions: against the port's dense attention (autograd) and the
    reference's chunked attention (its custom VJP)."""
    rng = np.random.default_rng(3)
    b, s, h, d = 2, 64, 4, 16
    q, k, v, g = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(4))
    pos = np.arange(s, dtype=np.int32)
    kw = dict(causal=causal, window=window)

    def ref(q_, k_, v_):
        return rattn.chunked_attention(q_, k_, v_, q_pos=pos, k_pos=pos, q_chunk=16, kv_chunk=16, **kw)

    r_out, r_vjp = jax.vjp(ref, q, k, v)
    r_grads = r_vjp(g)

    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tpos = torch.from_numpy(pos)
    out = tattn.chunked_attention(tq, tk, tv, q_pos=tpos, k_pos=tpos, q_chunk=16, kv_chunk=16, **kw)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    dense = tattn.dense_attention(tq, tk, tv, q_pos=tpos, k_pos=tpos, **kw)
    d_grads = torch.autograd.grad(dense, (tq, tk, tv), torch.from_numpy(g))

    close(out, r_out, what="out vs reference")
    close(out, dense.detach().numpy(), SELF_REL, what="out vs dense")
    for name, got, want, own in zip("qkv", grads, r_grads, d_grads):
        close(got, want, what=f"d{name} vs reference")
        close(got, own.numpy(), SELF_REL, what=f"d{name} vs dense")


def test_flash_attention_function_gradcheck():
    """`torch.autograd.gradcheck` of the flash `Function` in float64: causal
    with a window, two tiles a side, so the masked and the recomputed tiles
    are all exercised."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 8, 2, 4), generator=gen, dtype=torch.float64, requires_grad=True) for _ in range(3))
    assert torch.autograd.gradcheck(lambda a, b_, c: tattn._FlashAttention.apply(a, b_, c, True, 5, 4, 4),
                                    (q, k, v), eps=1e-6, atol=1e-8)


# -- MoE -------------------------------------------------------------------------------


@pytest.mark.parametrize("cap", [8, 16])
def test_moe_dispatch_indices_match_reference(cap):
    """slot_token, a_slot and fits equal `jax.vmap(_dispatch_row)`'s, with
    drops at capacity 8 and none at 16."""
    rng = np.random.default_rng(4)
    b, s, k, e = 3, 24, 2, 4
    ids = rng.integers(0, e, (b, s, k)).astype(np.int32)
    kw = dict(n_experts=e, cap=cap, s=s, k=k)
    want = jax.vmap(lambda x: rmoe._dispatch_row(x, **kw))(ids)
    got = tmoe._dispatch_row(torch.from_numpy(ids), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (cap == 8) == (not bool(got[2].all()))


@pytest.mark.parametrize("capacity_factor", [8.0, 0.25])
def test_moe_apply_matches_reference(capacity_factor):
    """y and the load balance within 1e-4, the dropped fraction exact: none
    at capacity factor 8, some at 0.25."""
    cfg = dataclasses.replace(FAMILIES["moe"], moe=rcommon.MoEConfig(n_experts=4, top_k=2,
                                                                      capacity_factor=capacity_factor))
    rparams = rmoe.moe_init(jax.random.PRNGKey(4), cfg)
    x = np.random.default_rng(5).standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    r_y, (r_lb, r_dropped) = jax.jit(lambda p, x_: rmoe.moe_apply(p, x_, cfg))(rparams, x)
    y, (lb, dropped) = tmoe.moe_apply(to_port(rparams), torch.from_numpy(x), port_config(cfg))
    close(y, r_y, what="y")
    close(lb, r_lb, what="load balance")
    assert float(dropped) == float(r_dropped)
    assert (float(dropped) > 0) == (capacity_factor < 1)


def test_moe_matches_naive_expert_loop():
    """Sorted-dispatch MoE (no drops) == the per-token loop over its top-2
    experts, with the reference's weights."""
    cfg = port_config(FAMILIES["deepseek_like"])
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_shared=0, capacity_factor=8.0))
    rcfg = dataclasses.replace(FAMILIES["deepseek_like"], moe=rcommon.MoEConfig(
        n_experts=8, top_k=3, d_expert=48, capacity_factor=8.0))
    params = to_port(rmoe.moe_init(jax.random.PRNGKey(5), rcfg))
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((1, 16, cfg.d_model)).astype(np.float32))
    y, (_, dropped) = tmoe.moe_apply(params, x, cfg)
    assert float(dropped) == 0.0

    flat = x.reshape(-1, cfg.d_model)
    gates = torch.softmax(flat @ params["router"], -1)
    top_g, top_e = torch.topk(gates, cfg.moe.top_k)
    ref = torch.zeros_like(flat)
    for t in range(flat.shape[0]):
        for j in range(cfg.moe.top_k):
            e = int(top_e[t, j])
            h = torch.nn.functional.silu(flat[t] @ params["w_gate"][e]) * (flat[t] @ params["w_up"][e])
            ref[t] += top_g[t, j] * (h @ params["w_down"][e])
    close(y.reshape(-1, cfg.d_model), ref.numpy(), what="moe vs loop")


# -- embedding backward ------------------------------------------------------------------


def test_embedding_grad_matches_reference_and_plain_indexing():
    """The sorted-scatter backward against the reference's custom VJP and
    against autograd of ``table[ids]``, with repeated ids."""
    rng = np.random.default_rng(7)
    v, d = 50, 8
    table = rng.standard_normal((v, d)).astype(np.float32)
    ids = rng.integers(0, v, (4, 10)).astype(np.int32)
    cot = rng.standard_normal((4, 10, d)).astype(np.float32)
    want = jax.vjp(lambda tb: rcommon.embed_lookup(tb, ids), table)[1](cot)[0]

    t = torch.from_numpy(table).requires_grad_(True)
    (got,) = torch.autograd.grad(tcommon.embed_lookup(t, torch.from_numpy(ids)), t, torch.from_numpy(cot))
    (plain,) = torch.autograd.grad(t[torch.from_numpy(ids).long()], t, torch.from_numpy(cot))
    close(got, want, what="vs reference")
    close(got, plain.numpy(), 1e-6, what="vs plain indexing")


# -- prefill and the ring cache ----------------------------------------------------------------


def test_prefill_block_matches_stepwise_decode():
    """A block prefill through decode_step == token-by-token decode (SWA,
    window 4 < 12 tokens), and the next step from either state agrees."""
    cfg = port_config(FAMILIES["swa"])
    params = to_port(ref_params(FAMILIES["swa"], 2))
    rng = np.random.default_rng(8)
    b, s = 2, 12
    toks = torch.from_numpy(_tokens(rng, cfg, b, s))
    nxt = torch.from_numpy(_tokens(rng, cfg, b, 1))
    with torch.no_grad():
        lg_block, st_block = tm.decode_step(params, tm.init_decode_state(cfg, b, s + 8, torch.float32,
                                                                         device="cpu"), toks, cfg)
        st_step = tm.init_decode_state(cfg, b, s + 8, torch.float32, device="cpu")
        for t in range(s):
            lg_step, st_step = tm.decode_step(params, st_step, toks[:, t:t + 1], cfg)
        close(lg_block[:, -1], lg_step[:, 0].numpy(), what="last logits")
        lg1, _ = tm.decode_step(params, st_block, nxt, cfg)
        lg2, _ = tm.decode_step(params, st_step, nxt, cfg)
    close(lg1, lg2.numpy(), what="next step")


def test_ring_cache_block_write_clamps_like_reference():
    """Three decode steps into a ring cache of 4 (SWA window 4), then a block
    of 3 at index 3: slot 3 + 3 > 4, so the write lands at 1 (the
    reference's `dynamic_update_slice` clamps, never wraps); then one more
    step. Logits and states against the reference's, `pos` exact."""
    rcfg = FAMILIES["swa"]
    cfg = port_config(rcfg)
    rparams = ref_params(rcfg, 3)
    params = to_port(rparams)
    rng = np.random.default_rng(9)
    b = 2
    feeds = [_tokens(rng, cfg, b, 1) for _ in range(3)] + [_tokens(rng, cfg, b, 3), _tokens(rng, cfg, b, 1)]
    r_step = jax.jit(lambda p, st, t: rm.decode_step(p, st, t, rcfg))
    r_st = rm.init_decode_state(rcfg, b, 16, jnp.float32)
    st = tm.init_decode_state(cfg, b, 16, torch.float32, device="cpu")
    with torch.no_grad():
        for tok in feeds:
            r_lg, r_st = r_step(rparams, r_st, tok)
            lg, st = tm.decode_step(params, st, torch.from_numpy(tok), cfg)
            close(lg, r_lg, what=f"logits after a block of {tok.shape[1]}")
            assert_trees(st, r_st, path="state")
    # the block of 3 at index 3 went to slots 1-3, the step at index 6 to slot 2
    np.testing.assert_array_equal(st["caches"][0]["pos"][0].numpy(), [0, 3, 6, 5])


def test_params_carry_across_with_their_dtypes():
    """A bfloat16 reference tree (jamba's smoke config: bfloat16 weights,
    float32 router, `a_log`, `d_skip`) and its decode state go to the port
    and back bit for bit, each leaf in its dtype."""
    import repro.configs.registry as rreg

    rcfg = rreg.get_smoke_config("jamba-v0.1-52b", dtype=jnp.bfloat16)
    trees = {"params": jax.jit(lambda key: rm.init_params(key, rcfg))(jax.random.PRNGKey(6)),
             "state": rm.init_decode_state(rcfg, 2, 8, jnp.bfloat16)}
    host = jax.tree.map(np.asarray, trees)
    port = tm.params_from_numpy(host, "cpu")
    assert port["params"]["layers"][1]["ffn"]["router"].dtype == torch.float32
    assert port["params"]["layers"][0]["mixer"]["a_log"].dtype == torch.float32
    assert port["params"]["embed"]["table"].dtype == torch.bfloat16
    assert port["state"]["index"].dtype == torch.int32 and port["state"]["index"].ndim == 0
    back = tm.params_to_numpy(port)
    flat_back, tree_back = jax.tree.flatten(back)
    flat_host, tree_host = jax.tree.flatten(host)
    assert tree_back == tree_host
    for b, h in zip(flat_back, flat_host):
        assert b.dtype == h.dtype and b.shape == h.shape
        np.testing.assert_array_equal(np.atleast_1d(b).view(np.uint8), np.atleast_1d(h).view(np.uint8))
