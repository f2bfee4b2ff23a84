"""Mamba-1 selective SSM mixer (Jamba's SSM layers). Counterpart of
`repro.models.mamba`.

in_proj -> causal depthwise conv -> selective scan (input-dependent dt, B,
C; diagonal A) -> gated out_proj. The scan forms exp(dt*A) and dt*B*x one
step at a time (no (B, S, D, N) tensor); a block runs the chunked scan, a
one-token decode step one step from the carried (conv, ssm) state.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import constrain
from repro_torch.models.common import ModelConfig, ParamInit, chunked_scan, dense_init, scan


def _dims(cfg: ModelConfig):
    d_inner = cfg.mamba_expand * cfg.d_model
    dt_rank = max(1, cfg.d_model // 16)
    return d_inner, dt_rank


def mamba_init(init: ParamInit, cfg: ModelConfig):
    d_inner, dt_rank = _dims(cfg)
    n = cfg.mamba_d_state
    a = torch.arange(1, n + 1, dtype=torch.float32, device=init.device)[None, :].expand(d_inner, n)
    return {
        "in_proj": dense_init(init, (cfg.d_model, 2 * d_inner), cfg.dtype),
        "conv_w": dense_init(init, (cfg.mamba_d_conv, d_inner), cfg.dtype, scale=0.5),
        "conv_b": init.full((d_inner,), 0.0, cfg.dtype),
        "x_proj": dense_init(init, (d_inner, dt_rank + 2 * n), cfg.dtype),
        "dt_proj": dense_init(init, (dt_rank, d_inner), cfg.dtype),
        "dt_bias": init.full((d_inner,), math.log(math.expm1(0.01)), cfg.dtype),
        "a_log": init.broadcast(torch.log(a)),                 # float32, (d_inner, N)
        "d_skip": init.full((d_inner,), 1.0, torch.float32),
        "out_proj": dense_init(init, (d_inner, cfg.d_model), cfg.dtype),
    }


def mamba_axes():
    return {
        "in_proj": ("fsdp", "mlp"),
        "conv_w": (None, "mlp"),
        "conv_b": ("mlp",),
        "x_proj": ("mlp", None),
        "dt_proj": (None, "mlp"),
        "dt_bias": ("mlp",),
        "a_log": ("mlp", None),
        "d_skip": ("mlp",),
        "out_proj": ("mlp", "fsdp"),
    }


def _ssm_coeffs(params, x, cfg: ModelConfig):
    """x: (B, S, d_inner) -> dt (B,S,D), b/c (B,S,N), float32."""
    _, dt_rank = _dims(cfg)
    n = cfg.mamba_d_state
    proj = torch.einsum("bsd,dk->bsk", x, params["x_proj"])
    dt_in, b, c = torch.split(proj, [dt_rank, n, n], dim=-1)
    dt = F.softplus(torch.einsum("bsk,kd->bsd", dt_in, params["dt_proj"]).float() + params["dt_bias"].float())
    return dt, b.float(), c.float()


def _causal_conv(params, x, cfg: ModelConfig, conv_state=None):
    """Depthwise causal conv along seq. x: (B,S,D). conv_state: (B, K-1, D)
    for decode. Returns (y, new_conv_state)."""
    kk = cfg.mamba_d_conv
    w = params["conv_w"].to(x.dtype)  # (K, D)
    if conv_state is None:
        prev = x.new_zeros((x.shape[0], kk - 1, x.shape[2]))
    else:
        prev = conv_state.to(x.dtype)
    xp = torch.cat([prev, x], dim=1)
    new_state = xp[:, -(kk - 1):, :] if kk > 1 else None
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(kk))
    return y + params["conv_b"].to(x.dtype), new_state


def mamba_apply(params, x, cfg: ModelConfig, *, state=None):
    """x: (B, S, d). state: {"conv": (B,K-1,D), "ssm": (B,D,N)} for decode.
    Returns (y, new_state)."""
    b_sz, s, _ = x.shape
    d_inner, _ = _dims(cfg)
    n = cfg.mamba_d_state

    xz = torch.einsum("bsd,de->bse", x, params["in_proj"])
    xs, z = xz.chunk(2, dim=-1)
    xs = constrain(xs, "batch", None, "mlp")

    conv_state = state["conv"] if state is not None else None
    xs, new_conv = _causal_conv(params, xs, cfg, conv_state)
    xs = F.silu(xs)

    dt, bmat, cmat = _ssm_coeffs(params, xs, cfg)
    a = -torch.exp(params["a_log"])                      # (D, N), negative

    h0 = state["ssm"] if state is not None else torch.zeros((b_sz, d_inner, n), dtype=torch.float32,
                                                              device=x.device)

    def step(h, inputs):
        dt_t, b_t, c_t, x_t = inputs                     # (B,D) (B,N) (B,N) (B,D)
        da_t = torch.exp(dt_t[..., None] * a)            # (B,D,N)
        h = da_t * h + (dt_t * x_t.float())[..., None] * b_t[:, None, :]
        h = constrain(h, "batch", "mlp", None)
        y = torch.einsum("bdn,bn->bd", h, c_t)
        return h, y

    seq_xs = (dt.transpose(0, 1), bmat.transpose(0, 1), cmat.transpose(0, 1), xs.transpose(0, 1))
    if s > 1:
        h_last, ys = chunked_scan(step, h0, seq_xs, chunk=128)
    else:
        h_last, ys = scan(step, h0, seq_xs)
    y = ys.transpose(0, 1)                                # (B,S,D)

    y = y + xs.float() * params["d_skip"]
    y = y.to(x.dtype) * F.silu(z)
    out = torch.einsum("bsd,de->bse", y, params["out_proj"])
    return out, {"conv": new_conv, "ssm": h_last}


def mamba_state_init(cfg: ModelConfig, batch: int, *, device=None, lead: tuple[int, ...] = ()):
    d_inner, _ = _dims(cfg)
    return {
        "conv": torch.zeros(lead + (batch, cfg.mamba_d_conv - 1, d_inner), dtype=cfg.dtype, device=device),
        "ssm": torch.zeros(lead + (batch, d_inner, cfg.mamba_d_state), dtype=torch.float32, device=device),
    }
