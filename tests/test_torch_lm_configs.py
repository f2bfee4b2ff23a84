"""Port parity of the architecture configs and their smoke runs
(`repro_torch.configs`, `repro_torch.launch.serve.generate`) against
`repro.configs` and `repro.models` on the CPU.

For each of the ten architectures: ``config()`` and ``smoke_config()``
field for field (dtypes mapped); the exact parameter count, built on the
``meta`` device; `param_axes` against the parameters made on ``meta``, in
structure and rank (and `decode_state_axes` against the decode state);
`input_specs` against the reference's shapes and dtypes in every supported
shape cell; the smoke config's forward logits and one decode step from the
reference's parameters. Greedy generation (batch 2, prompt 8, 8 tokens)
against a jitted reference loop for four architectures.

Tolerances: logits within 1e-4 x max|reference| (float32); counts,
shapes, dtypes and greedy tokens exact.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs.registry as rreg  # noqa: E402
import repro.models as rm  # noqa: E402
import repro_torch.configs.registry as treg  # noqa: E402
import repro_torch.models as tm  # noqa: E402
from repro.models import transformer as rtr  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.distributed.sharding import is_axes  # noqa: E402
from test_torch_models import assert_trees, close, port_config, ref_params, to_port, torch_dtype  # noqa: E402

ARCHS = list(rreg.ARCH_IDS)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_arch_ids_match_reference():
    assert treg.ARCH_IDS == rreg.ARCH_IDS
    assert treg.SHAPES == {k: treg.ShapeSpec(**dataclasses.asdict(v)) for k, v in rreg.SHAPES.items()}
    for arch in ARCHS:
        for shape in rreg.SHAPES:
            assert treg.cell_supported(arch, shape) == rreg.cell_supported(arch, shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_param_count_match_reference(arch):
    """config() and smoke_config() field for field, in both default dtypes
    and in float32; the full config's parameter count exactly."""
    for kw in ({}, {"dtype": jnp.float32}):
        tkw = {"dtype": torch_dtype(kw["dtype"])} if kw else {}
        assert treg.get_config(arch, **tkw) == port_config(rreg.get_config(arch, **kw))
        assert treg.get_smoke_config(arch, **tkw) == port_config(rreg.get_smoke_config(arch, **kw))
    cfg = treg.get_config(arch)
    assert cfg.dtype == torch.bfloat16 and treg.get_smoke_config(arch).dtype == torch.float32
    assert cfg.param_count() == rreg.get_config(arch).param_count()


def _leaves_with_axes(tree, axes, path=""):
    """(path, leaf, axes tuple) for every leaf of ``tree``, walking ``axes``
    beside it (fails where the structures differ)."""
    if isinstance(tree, dict):
        assert isinstance(axes, dict) and set(tree) == set(axes), (path, sorted(tree), axes)
        return [x for k in tree for x in _leaves_with_axes(tree[k], axes[k], f"{path}/{k}")]
    if isinstance(tree, tuple):
        assert isinstance(axes, tuple) and not is_axes(axes) and len(axes) == len(tree), path
        return [x for i, (t, a) in enumerate(zip(tree, axes)) for x in _leaves_with_axes(t, a, f"{path}/{i}")]
    assert is_axes(axes), (path, axes)
    return [(path, tree, axes)]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_match_meta_params(arch):
    """`param_axes` mirrors `init_params` on ``meta`` (nothing allocated),
    every leaf's rank its axes' length, and the leaves' shapes and dtypes
    are the reference's; `decode_state_axes` mirrors `init_decode_state`."""
    cfg = treg.get_config(arch)
    params = tm.init_params(None, cfg, device="meta")
    for path, leaf, axes in _leaves_with_axes(params, tm.param_axes(cfg)):
        assert leaf.device.type == "meta" and leaf.ndim == len(axes), (path, leaf.shape, axes)
    shapes = jax.eval_shape(lambda k: rm.init_params(k, rreg.get_config(arch)), jax.random.PRNGKey(0))
    assert [(tuple(t.shape), t.dtype) for t in tcommon.tree_leaves(params)] == [
        (tuple(s.shape), torch_dtype(s.dtype)) for s in jax.tree.leaves(shapes)]
    state = tm.init_decode_state(cfg, 2, 64, cfg.dtype, device="meta")
    for path, leaf, axes in _leaves_with_axes(state, tm.decode_state_axes(cfg)):
        assert leaf.ndim == len(axes), (path, leaf.shape, axes)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch):
    """Every supported shape cell: the same inputs, shapes and dtypes (the
    decode state's caches included), all on ``meta``."""
    cfg, rcfg = treg.get_config(arch), rreg.get_config(arch)
    for name, shape in rreg.SHAPES.items():
        if not rreg.cell_supported(arch, name)[0]:
            continue
        got = treg.input_specs(cfg, treg.SHAPES[name])
        want = rreg.input_specs(rcfg, shape)
        assert list(got) == list(want), (name, list(got), list(want))
        g_leaves, w_leaves = tcommon.tree_leaves(got), jax.tree.leaves(want)
        assert [(tuple(t.shape), t.dtype) for t in g_leaves] == [
            (tuple(s.shape), torch_dtype(s.dtype)) for s in w_leaves], name
        assert all(t.device.type == "meta" for t in g_leaves)


def _smoke_inputs(cfg, rng, b=2, s=16):
    batch = {"inputs": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.encoder_layers:
        batch["frames"] = rng.standard_normal((b, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    if cfg.prefix_tokens:
        batch["prefix_embeddings"] = rng.standard_normal((b, cfg.prefix_tokens, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward_and_decode_match_reference(arch):
    """The smoke config from the reference's parameters: forward logits, and
    one decode step from an empty state (with the encoder's states for
    whisper)."""
    rcfg = rreg.get_smoke_config(arch)
    cfg = treg.get_smoke_config(arch)
    rparams = ref_params(rcfg, 1)
    params = to_port(rparams)
    batch = _smoke_inputs(rcfg, np.random.default_rng(20))
    kwargs = {k: batch[k] for k in ("frames", "prefix_embeddings") if k in batch}
    r_logits = jax.jit(lambda p, t, kw: rm.forward(p, t, rcfg, **kw))(rparams, batch["inputs"], kwargs)

    r_enc = jax.jit(lambda p, f: rtr.encode(p, f, rcfg))(rparams, batch["frames"]) if "frames" in batch else None
    tok = batch["inputs"][:, :1]
    r_lg, r_st = jax.jit(lambda p, st, t, e: rm.decode_step(p, st, t, rcfg, enc_out=e))(
        rparams, rm.init_decode_state(rcfg, 2, 32, rcfg.dtype), tok, r_enc)

    with torch.no_grad():
        logits = tm.forward(params, torch.from_numpy(batch["inputs"]), cfg,
                            **{k: torch.from_numpy(v) for k, v in kwargs.items()})
        enc = tm.encode(params, torch.from_numpy(batch["frames"]), cfg) if "frames" in batch else None
        lg, st = tm.decode_step(params, tm.init_decode_state(cfg, 2, 32, cfg.dtype, device="cpu"),
                                torch.from_numpy(tok), cfg, enc_out=enc)
    assert logits.shape == (2, 16 + cfg.prefix_tokens, cfg.vocab_size)
    close(logits, r_logits, what="forward")
    close(lg, r_lg, what="decode")
    assert_trees(st, r_st, path="state")


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "jamba-v0.1-52b", "xlstm-1.3b", "whisper-tiny"])
def test_generate_matches_reference_greedy_loop(arch):
    """`generate` (block prefill of 8, then 7 one-token steps, batch 2) gives
    the reference's greedy tokens, and its last logits match."""
    rcfg = rreg.get_smoke_config(arch)
    cfg = treg.get_smoke_config(arch)
    rparams = ref_params(rcfg, 2)
    rng = np.random.default_rng(21)
    prompt = rng.integers(0, rcfg.vocab_size, (2, 8)).astype(np.int32)
    frames = rng.standard_normal((2, rcfg.encoder_frames, rcfg.d_model)).astype(np.float32) \
        if rcfg.encoder_layers else None
    n_tokens = 8

    r_enc = jax.jit(lambda p, f: rtr.encode(p, f, rcfg))(rparams, frames) if frames is not None else None
    r_step = jax.jit(lambda p, st, t, e: rm.decode_step(p, st, t, rcfg, enc_out=e))
    st = rm.init_decode_state(rcfg, 2, 8 + n_tokens, rcfg.dtype)
    lg, st = r_step(rparams, st, prompt, r_enc)
    tok = jnp.argmax(lg[:, -1:], -1)
    want = [tok]
    for _ in range(n_tokens - 1):
        lg, st = r_step(rparams, st, tok, r_enc)
        tok = jnp.argmax(lg[:, -1:], -1)
        want.append(tok)
    want = np.asarray(jnp.concatenate(want, axis=1))

    params = to_port(rparams)
    enc = None
    if frames is not None:
        with torch.no_grad():
            enc = tm.encode(params, torch.from_numpy(frames), cfg)
    g = generate(params, cfg, torch.from_numpy(prompt), n_tokens, enc_out=enc)
    assert g.finite and g.prefill_ms > 0 and g.decode_ms > 0
    np.testing.assert_array_equal(g.tokens.numpy(), want)
    close(g.logits, lg[:, -1], what="last logits")
