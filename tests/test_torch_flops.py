"""The port's analytic FLOP and byte model (`repro_torch.launch.flops`)
against `repro.launch.flops`: `forward_flops` and `cell_costs` for every
architecture x shape cell, within rtol 1e-12 (the same float arithmetic
over the same config fields; the parameter count, from the parameters made
on the ``meta`` device, is exact)."""

import pytest

torch = pytest.importorskip("torch")

import repro.configs.registry as rreg  # noqa: E402
import repro.launch.flops as rflops  # noqa: E402
import repro_torch.configs.registry as treg  # noqa: E402
import repro_torch.launch.flops as tflops  # noqa: E402

RTOL = 1e-12


def _close(got: float, want: float, what: str) -> None:
    assert abs(got - want) <= RTOL * abs(want), f"{what}: {got!r} against {want!r}"


@pytest.mark.parametrize("arch", list(rreg.ARCH_IDS))
def test_flops_and_cell_costs_match_reference(arch):
    rcfg, tcfg = rreg.get_config(arch), treg.get_config(arch)
    assert tcfg.param_count() == rcfg.param_count()
    for name, shape in rreg.SHAPES.items():
        b, s = shape.global_batch, shape.seq_len
        for kw in (dict(n_tokens=b * s, s_ctx=s / 2, enc_tokens=b * rcfg.encoder_frames),
                   dict(n_tokens=b, s_ctx=s)):
            _close(tflops.forward_flops(tcfg, **kw), rflops.forward_flops(rcfg, **kw), f"{arch} {name} {kw}")
        if not rreg.cell_supported(arch, name)[0]:
            continue
        for chips in (1, 512):
            want = rflops.cell_costs(rcfg, shape, chips)
            got = tflops.cell_costs(tcfg, treg.SHAPES[name], chips)
            assert set(got) == set(want) == {"flops", "bytes"}
            for k in want:
                _close(got[k], want[k], f"{arch} {name} chips={chips} {k}")
