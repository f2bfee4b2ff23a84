"""Port parity of the language-model stack's collectives over a stacked
mesh axis (`repro_torch.distributed.compression`'s int8 error-feedback
all-reduce, `repro_torch.distributed.pipeline`) against
`repro.distributed` on the CPU, and checks B and C of
tests/dist_lm_check.py on examples/torch_dist_lm.py.

- The reference runs under ``jax.vmap(..., axis_name="data")``: its
  collectives reduce over the vmapped axis, which the port holds as the
  leading dim of each leaf. The compressed and exact reductions and the
  residuals are bit-equal for 1, 3 and 8 shards, float32 and bfloat16
  gradients, over 3 rounds that carry the residuals. Eagerly: under
  ``jax.jit`` XLA fuses the reference's quantize step, and its residuals
  then differ by a rounding.
- The error-feedback properties of tests/test_compression.py.
- Check C: the reference's two criteria over 60 steps; one step from the
  reference's local gradients bit-equal in the reduction and residuals,
  the updated parameters within 1e-6.
- GPipe within 1e-5 of the sequential composition (check B's shapes, M <
  S, S = 1, and the gradients) and of the reference's `pipeline_forward`
  on 4 forced host devices (a subprocess: the device count is fixed when
  JAX starts).
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.distributed.compression as rc  # noqa: E402
import repro_torch.distributed.compression as tc  # noqa: E402
from repro.optim import AdamWConfig as RAdamWConfig  # noqa: E402
from repro.optim import adamw_init as radamw_init  # noqa: E402
from repro.optim import adamw_update as radamw_update  # noqa: E402
from repro_torch.distributed.pipeline import pipeline_forward  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("torch_dist_lm", ROOT / "examples" / "torch_dist_lm.py")
ex = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ex)

TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_compress(grads, residuals):
    return jax.vmap(lambda g, r: rc.compressed_psum_grads(g, r, "data"), axis_name="data")(grads, residuals)


def ref_mean(grads):
    return jax.vmap(lambda g: rc.exact_pmean_grads(g, "data"), axis_name="data")(grads)


def to_torch(a, dtype=None):
    t = torch.from_numpy(np.array(np.asarray(a, np.float32)))
    return t if dtype is None else t.to(dtype)


def same(got, want) -> bool:
    """Bit-equal: the port's tensor against the reference's array."""
    want = np.asarray(want)
    return str(got.dtype) == f"torch.{want.dtype.name}" and np.array_equal(got.float().numpy(), want.astype(np.float32))


# ---------------------------------------------------------------------------
# the error-feedback int8 all-reduce
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 3, 8])
def test_reductions_bit_equal_reference_under_vmap(n, dtype):
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    rng = np.random.default_rng(n)
    r_res = {"b": jnp.zeros((n, 5), jnp.float32), "w": jnp.zeros((n, 7, 6), jnp.float32)}
    t_res = tc.zeros_like_residual({"b": torch.zeros((n, 5), dtype=td), "w": torch.zeros((n, 7, 6), dtype=td)})
    assert all(r.dtype == torch.float32 for r in t_res.values())
    for k in range(3):
        g = {"w": rng.normal(size=(n, 7, 6)) * 10.0 ** rng.uniform(-3, 1), "b": rng.normal(size=(n, 5)) * 1e-2}
        r_g = {key: jnp.asarray(v, jnp.float32).astype(jd) for key, v in g.items()}
        t_g = {key: to_torch(v, td) for key, v in g.items()}
        r_mean, r_res = ref_compress(r_g, r_res)
        t_mean, t_res = tc.compressed_psum_grads(t_g, t_res)
        r_exact, t_exact = ref_mean(r_g), tc.exact_pmean_grads(t_g)
        for key in g:
            assert same(t_mean[key], r_mean[key][0]), (key, k)         # the reference's output is replicated
            assert same(t_res[key], r_res[key]), (key, k)
            assert same(t_exact[key], r_exact[key][0]), (key, k)
            assert t_mean[key].shape == t_g[key].shape[1:]
        assert float(t_res["w"].abs().max()) > 0


def test_error_feedback_residual_identity():
    """One shard: the reduced value is dequant(quant(g)), so it plus the new
    residual gives g back to float32 round-off."""
    g = {"w": to_torch(np.random.default_rng(3).normal(size=(1, 16, 16)))}
    out, res = tc.compressed_psum_grads(g, tc.zeros_like_residual(g))
    np.testing.assert_allclose((out["w"] + res["w"][0]).numpy(), g["w"][0].numpy(), rtol=0, atol=1e-6)
    assert float(res["w"].abs().max()) > 0


def test_error_feedback_error_does_not_accumulate():
    """With the residual fed forward the accumulated reduced sum stays within
    two quantization steps of the true sum over 50 rounds."""
    g = {"w": to_torch(np.random.default_rng(4).normal(size=(1, 8, 8)) * 1e-3 + 5e-3)}
    res = tc.zeros_like_residual(g)
    acc = np.zeros((8, 8))
    for _ in range(50):
        out, res = tc.compressed_psum_grads(g, res)
        acc += out["w"].double().numpy()
    scale = float(g["w"].abs().max()) / 127.0
    assert np.abs(acc - 50 * g["w"][0].double().numpy()).max() <= 2 * scale


def test_compressed_matches_exact_on_uniform_grads():
    g = {"w": torch.full((4, 4, 4), 0.5)}
    exact = tc.exact_pmean_grads(g)
    comp, _ = tc.compressed_psum_grads(g, tc.zeros_like_residual(g))
    np.testing.assert_allclose(comp["w"].numpy(), exact["w"].numpy(), rtol=0, atol=0.5 / 127.0)


# ---------------------------------------------------------------------------
# check C: data-parallel training with the compressed all-reduce
# ---------------------------------------------------------------------------


def test_compressed_dp_meets_the_reference_criteria():
    exact, comp = ex.dp_run(False, "cpu"), ex.dp_run(True, "cpu")
    assert len(comp) == ex.STEPS and all(np.isfinite(comp + exact))
    assert comp[-1] < comp[0] * 0.2, comp[::20]
    assert comp[-1] < exact[-1] * 1.5 + 1e-3, (comp[-1], exact[-1])
    assert ex.dp_criteria(exact, comp)


def test_compressed_dp_step_matches_reference():
    """Two steps from the same state on the reference's local gradients
    (the second with the residuals of the first): the port's reductions and
    residuals bit-equal, its parameters within 1e-6 of the reference's."""
    w0, w_true, xs = ex.dp_inputs()

    def local_loss(w, x):
        return jnp.mean((x @ w - x @ w_true) ** 2)

    grads_of = jax.vmap(jax.grad(local_loss), in_axes=(None, 0))
    cfg = RAdamWConfig(**{k: getattr(ex.DP_OPT, k) for k in ("lr", "b1", "b2", "eps", "weight_decay", "grad_clip")})
    r_w, r_opt, r_res = jnp.asarray(w0), radamw_init(jnp.asarray(w0)), jnp.zeros((ex.SHARDS, ex.D, ex.D))
    t_w = torch.from_numpy(w0.copy())
    t_opt, t_res = adamw_init(t_w), torch.zeros((ex.SHARDS, ex.D, ex.D))
    for i in range(2):
        g_local = np.asarray(grads_of(r_w, jnp.asarray(xs[i]).reshape(ex.SHARDS, -1, ex.D)))
        r_g, r_res = ref_compress(jnp.asarray(g_local), r_res)
        r_w, r_opt, _ = radamw_update(r_g[0], r_opt, r_w, cfg)
        t_g, t_res = ex.dp_update_(t_w, t_opt, t_res, torch.from_numpy(g_local), compress=True)
        assert same(t_g, r_g[0]) and same(t_res, r_res), i
        np.testing.assert_allclose(t_w.numpy(), np.asarray(r_w), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# check B: GPipe over stacked stages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stages,micro", [(4, 8), (4, 2), (1, 3)])
def test_pipeline_equals_sequential_composition(stages, micro):
    rng = np.random.default_rng(stages * 10 + micro)
    w = to_torch(rng.normal(size=(stages, ex.D, ex.D)) * 0.3)
    x = to_torch(rng.normal(size=(micro, ex.MB, ex.D)))
    got, ref = ex.pipeline_check(w, x)
    assert got.shape == (micro, ex.MB, ex.D)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=TOL, atol=TOL)


def test_pipeline_gradients_equal_sequential_composition():
    w, x = (to_torch(a).requires_grad_(True) for a in ex.pipeline_inputs())
    got, ref = ex.pipeline_check(w, x)
    cot = to_torch(np.random.default_rng(5).normal(size=got.shape))
    g_pipe = torch.autograd.grad(got, (w, x), cot)
    g_seq = torch.autograd.grad(ref, (w, x), cot)
    for a, b in zip(g_pipe, g_seq):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=TOL)


def test_pipeline_refuses_a_stage_count_off_the_mesh():
    w, x = (to_torch(a) for a in ex.pipeline_inputs())
    with pytest.raises(ValueError, match="4 stages"):
        pipeline_forward(w[:3], x, ex.tanh_stage, mesh={"pipe": 4})


_REF_PIPELINE = """
import sys
import numpy as np
import jax.numpy as jnp
from repro.compat import make_mesh_compat
from repro.distributed.pipeline import pipeline_forward
w, x = np.load(sys.argv[1]), np.load(sys.argv[2])
out = pipeline_forward(jnp.asarray(w), jnp.asarray(x), lambda wi, v: jnp.tanh(v @ wi),
                       mesh=make_mesh_compat((w.shape[0],), ("pipe",)))
np.save(sys.argv[3], np.asarray(out))
"""


def test_pipeline_matches_reference_on_four_host_devices(tmp_path):
    w, x = ex.pipeline_inputs()
    np.save(tmp_path / "w.npy", w)
    np.save(tmp_path / "x.npy", x)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run([sys.executable, "-c", _REF_PIPELINE, str(tmp_path / "w.npy"), str(tmp_path / "x.npy"),
                          str(tmp_path / "out.npy")], env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    got, _ = ex.pipeline_check(torch.from_numpy(w), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.load(tmp_path / "out.npy"), rtol=TOL, atol=TOL)
