"""The port's CUDA kernels on the card: each held to its plain PyTorch
version, and the windowed simulation run through every backend.

These tests need a CUDA device and skip without one (the kernels have no
CPU mode). They import neither JAX nor `repro`, so they run where only the
port is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: a kernel against its plain version, rtol 1e-5 / atol 1e-5 (the
kernels sum over the slots in order in registers, the plain versions through
cuBLAS batched products); backends after 8 windowed steps, 1e-4 of the
field's largest magnitude (those sums compound through the field solve).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.api import make_simulation, scenario  # noqa: E402
from repro_torch.core import bin_slab_staging, build_bins, cell_index, max_guard  # noqa: E402
from repro_torch.kernels.deposition import ops as dep  # noqa: E402
from repro_torch.kernels.deposition import ref as dep_ref  # noqa: E402
from repro_torch.kernels.gather import ops as gat  # noqa: E402
from repro_torch.kernels.gather import ref as gat_ref  # noqa: E402

ORDERS = [1, 2, 3]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _slab(grid, n, capacity, seed, device):
    rng = np.random.default_rng(seed)
    pos = torch.from_numpy((rng.random((n, 3)) * np.asarray(grid)).astype(np.float32)).to(device)
    vel = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(device)
    qw = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)).to(device)
    alive = torch.ones(n, dtype=torch.bool, device=device)
    layout, overflow = build_bins(cell_index(pos, grid), alive, n_cells=int(np.prod(grid)), capacity=capacity)
    assert int(overflow) == 0
    slab, val = bin_slab_staging(pos, vel, qw, layout, grid_shape=grid)
    return slab.d, val.contiguous()


def _close(a, b, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("order", ORDERS)
def test_kernels_match_plain_versions(order, cuda):
    grid, g = (6, 5, 7), max_guard(order)
    d, val = _slab(grid, 1500, 64, order, cuda)
    before = kernels.launch_counts()
    _close(dep.fused_bin_deposit(d, val, order=order), dep_ref.fused_bin_deposit_ref(d, val, order=order))
    _close(
        dep.fused_bin_deposit_reduced(d, val, order=order, grid_shape=grid, guard=g),
        dep_ref.fused_bin_deposit_reduced_ref(d, val, order=order, grid_shape=grid, guard=g),
    )
    padded = torch.randn(6, *(n + 2 * g for n in grid), device=cuda)
    _close(
        gat.fused_bin_gather(d, padded, grid_shape=grid, order=order, guard=g),
        gat_ref.fused_gather_ref(d, padded, grid_shape=grid, order=order, guard=g),
    )
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert all(after[k] == before[k] + 1 for k in after)


@pytest.mark.gpu
def test_windowed_backends_agree(cuda):
    fields = {}
    for backend in ("cuda_reduced", "cuda", "torch"):
        kernels.reset_launch_counts()
        sim = make_simulation(scenario("uniform", grid=(16, 16, 16), order=2, steps=8, window=4, backend=backend))
        assert sim.device.type == "cuda"
        sim.run()
        counts = kernels.launch_counts()
        if backend == "torch":
            assert set(counts.values()) == {0}
        else:
            assert counts["fused_bin_gather"] == 8
            assert counts["fused_bin_deposit_reduced" if backend == "cuda_reduced" else "fused_bin_deposit"] == 8
        fields[backend] = [f.cpu().numpy() for f in sim.state.fields.all()]
    for backend in ("cuda", "torch"):
        for a, b in zip(fields[backend], fields["cuda_reduced"]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * max(np.abs(b).max(), 1e-30))


@pytest.mark.gpu
def test_tall_column_and_large_capacity(cuda):
    """Shapes off the main path: a 256-cell column whose accumulator needs
    more than the default 48 KB of shared memory (the launcher raises the
    limit), and a capacity above one block of gather threads."""
    g = max_guard(3)
    grid = (2, 2, 256)
    d, val = _slab(grid, 6000, 24, 7, cuda)
    _close(
        dep.fused_bin_deposit_reduced(d, val, order=3, grid_shape=grid, guard=g),
        dep_ref.fused_bin_deposit_reduced_ref(d, val, order=3, grid_shape=grid, guard=g),
    )
    grid = (3, 3, 3)
    d, val = _slab(grid, 3000, 320, 8, cuda)
    padded = torch.randn(6, *(n + 2 * g for n in grid), device=cuda)
    _close(dep.fused_bin_deposit(d, val, order=3), dep_ref.fused_bin_deposit_ref(d, val, order=3))
    _close(
        gat.fused_bin_gather(d, padded, grid_shape=grid, order=3, guard=g),
        gat_ref.fused_gather_ref(d, padded, grid_shape=grid, order=3, guard=g),
    )
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_wrapper_refuses_a_column_over_the_shared_memory_limit(cuda):
    grid = (1, 1, 1000)
    d = torch.zeros(1000, 8, 3, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        dep.fused_bin_deposit_reduced(d, d.clone(), order=3, grid_shape=grid, guard=max_guard(3))
