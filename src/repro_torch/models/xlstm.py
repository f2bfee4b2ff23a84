"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM
(scalar memory), with exponential gating and the max-state stabilizer.
Counterpart of `repro.models.xlstm`.

The cell math is the paper's; the block plumbing is the reference's reduced
form: the pre-up-projection mLSTM (pf 2) with a causal conv on its q/k
path, the post-up-projection sLSTM (pf 4/3) GLU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import constrain
from repro_torch.models.common import ModelConfig, ParamInit, chunked_scan, dense_init, gelu, scan

MLSTM_PF = 2.0


def _mlstm_dims(cfg: ModelConfig):
    d_inner = int(MLSTM_PF * cfg.d_model)
    hd = d_inner // cfg.n_heads
    return d_inner, hd


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_init(init: ParamInit, cfg: ModelConfig):
    d_inner, hd = _mlstm_dims(cfg)
    # q/k/v are per-head block-diagonal projections (heads don't mix)
    return {
        "up_proj": dense_init(init, (cfg.d_model, 2 * d_inner), cfg.dtype),
        "conv_w": dense_init(init, (4, d_inner), cfg.dtype, scale=0.5),
        "wq": dense_init(init, (cfg.n_heads, hd, hd), cfg.dtype, scale=hd**-0.5),
        "wk": dense_init(init, (cfg.n_heads, hd, hd), cfg.dtype, scale=hd**-0.5),
        "wv": dense_init(init, (cfg.n_heads, hd, hd), cfg.dtype, scale=hd**-0.5),
        "w_igate": dense_init(init, (d_inner, cfg.n_heads), torch.float32, scale=0.01),
        "b_igate": init.full((cfg.n_heads,), 0.0, torch.float32),
        "w_fgate": dense_init(init, (d_inner, cfg.n_heads), torch.float32, scale=0.01),
        "b_fgate": init.full((cfg.n_heads,), 3.0, torch.float32),  # forget ~ on
        "down_proj": dense_init(init, (d_inner, cfg.d_model), cfg.dtype),
    }


def mlstm_axes():
    return {
        "up_proj": ("fsdp", "mlp"),
        "conv_w": (None, "mlp"),
        "wq": ("heads", None, None),
        "wk": ("heads", None, None),
        "wv": ("heads", None, None),
        "w_igate": ("mlp", "heads"),
        "b_igate": ("heads",),
        "w_fgate": ("mlp", "heads"),
        "b_fgate": ("heads",),
        "down_proj": ("mlp", "fsdp"),
    }


def _causal_conv4(w, x, conv_state=None):
    """Depthwise causal conv (K=4) with carried state for decode.
    Returns (y, new_conv_state (B, 3, D))."""
    prev = conv_state.to(x.dtype) if conv_state is not None else x.new_zeros((x.shape[0], 3, x.shape[2]))
    xp = torch.cat([prev, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w.to(x.dtype)[i] for i in range(4))
    return y, xp[:, -3:, :]


def mlstm_apply(params, x, cfg: ModelConfig, *, state=None):
    """x: (B,S,d). state: {"c": (B,H,hd,hd), "n": (B,H,hd), "m": (B,H),
    "conv": (B,3,d_inner)}. Returns (y, state)."""
    b, s, _ = x.shape
    d_inner, hd = _mlstm_dims(cfg)
    h_heads = cfg.n_heads

    up = torch.einsum("bsd,de->bse", x, params["up_proj"])
    xi, z = up.chunk(2, dim=-1)
    xi = constrain(xi, "batch", None, "mlp")
    xc, new_conv = _causal_conv4(params["conv_w"], xi, state["conv"] if state is not None else None)
    xc = F.silu(xc)

    xc_h = xc.reshape(b, s, h_heads, hd)
    xi_h = xi.reshape(b, s, h_heads, hd)
    q = torch.einsum("bshe,hef->bshf", xc_h, params["wq"]) * hd**-0.5
    k = torch.einsum("bshe,hef->bshf", xc_h, params["wk"])
    v = torch.einsum("bshe,hef->bshf", xi_h, params["wv"])

    xf = xc.float()
    i_pre = torch.einsum("bsd,dh->bsh", xf, params["w_igate"]) + params["b_igate"]
    f_pre = torch.einsum("bsd,dh->bsh", xf, params["w_fgate"]) + params["b_fgate"]

    if state is None:
        c0 = torch.zeros((b, h_heads, hd, hd), dtype=torch.float32, device=x.device)
        n0 = torch.zeros((b, h_heads, hd), dtype=torch.float32, device=x.device)
        m0 = torch.full((b, h_heads), -1e30, dtype=torch.float32, device=x.device)
    else:
        c0, n0, m0 = state["c"], state["n"], state["m"]

    def step(carry, inp):
        c, n, m = carry
        q_t, k_t, v_t, i_t, f_t = inp  # (B,H,hd) x3, (B,H) x2
        log_f = F.logsigmoid(f_t)
        m_new = torch.maximum(log_f + m, i_t)
        f_eff = torch.exp(log_f + m - m_new)
        i_eff = torch.exp(i_t - m_new)
        kf = k_t.float()
        vf = v_t.float()
        c = f_eff[..., None, None] * c + i_eff[..., None, None] * (kf[..., :, None] * vf[..., None, :])
        c = constrain(c, "batch", None, None, "mlp")
        n = f_eff[..., None] * n + i_eff[..., None] * kf
        qf = q_t.float()
        num = torch.einsum("bhk,bhkv->bhv", qf, c)
        den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", qf, n)), torch.exp(-m_new))
        y = num / den[..., None]
        return (c, n, m_new), y

    xs = tuple(t.transpose(0, 1) for t in (q, k, v, i_pre, f_pre))
    if s > 1:
        (c_f, n_f, m_f), ys = chunked_scan(step, (c0, n0, m0), xs, chunk=64)
    else:
        (c_f, n_f, m_f), ys = scan(step, (c0, n0, m0), xs)
    y = ys.transpose(0, 1).reshape(b, s, d_inner).to(x.dtype)

    y = y * F.silu(z)
    out = torch.einsum("bse,ed->bsd", y, params["down_proj"])
    return out, {"c": c_f, "n": n_f, "m": m_f, "conv": new_conv}


def mlstm_state_init(cfg: ModelConfig, batch: int, *, device=None, lead: tuple[int, ...] = ()):
    d_inner, hd = _mlstm_dims(cfg)
    return {
        "c": torch.zeros(lead + (batch, cfg.n_heads, hd, hd), dtype=torch.float32, device=device),
        "n": torch.zeros(lead + (batch, cfg.n_heads, hd), dtype=torch.float32, device=device),
        "m": torch.full(lead + (batch, cfg.n_heads), -1e30, dtype=torch.float32, device=device),
        "conv": torch.zeros(lead + (batch, 3, d_inner), dtype=cfg.dtype, device=device),
    }


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_init(init: ParamInit, cfg: ModelConfig):
    d = cfg.d_model
    bias = torch.cat([torch.zeros(d, device=init.device), torch.full((d,), 3.0, device=init.device),
                      torch.zeros(2 * d, device=init.device)])
    return {
        "w_in": dense_init(init, (d, 4 * d), cfg.dtype),          # i,f,z,o pre-acts
        "r_in": dense_init(init, (d, 4 * d), cfg.dtype, scale=d**-0.5),
        "bias": init.broadcast(bias),                             # float32
        "up_gate": dense_init(init, (d, int(4 * d / 3)), cfg.dtype),
        "up": dense_init(init, (d, int(4 * d / 3)), cfg.dtype),
        "down": dense_init(init, (int(4 * d / 3), d), cfg.dtype),
    }


def slstm_axes():
    return {
        "w_in": ("fsdp", "mlp"),
        "r_in": (None, "mlp"),
        "bias": ("mlp",),
        "up_gate": ("fsdp", "mlp"),
        "up": ("fsdp", "mlp"),
        "down": ("mlp", "fsdp"),
    }


def slstm_apply(params, x, cfg: ModelConfig, *, state=None):
    """Scalar-memory LSTM with exponential gating + stabilizer, then the
    post-up-projection GLU FFN. state: {"c","n","m","h"} each (B,d)."""
    b, s, d = x.shape
    pre = torch.einsum("bsd,de->bse", x, params["w_in"])

    if state is None:
        zeros = torch.zeros((b, d), dtype=torch.float32, device=x.device)
        c0, n0, m0, h0 = zeros, zeros, torch.full((b, d), -1e30, dtype=torch.float32, device=x.device), zeros
    else:
        c0, n0, m0, h0 = state["c"], state["n"], state["m"], state["h"]

    r_w = params["r_in"]
    bias = params["bias"]

    def step(carry, pre_t):
        c, n, m, h = carry
        gates = pre_t.float() + torch.einsum("bd,de->be", h.to(x.dtype), r_w).float() + bias
        i_t, f_t, z_t, o_t = gates.chunk(4, dim=-1)
        log_f = F.logsigmoid(f_t)
        m_new = torch.maximum(log_f + m, i_t)
        f_eff = torch.exp(log_f + m - m_new)
        i_eff = torch.exp(i_t - m_new)
        c = f_eff * c + i_eff * torch.tanh(z_t)
        n = f_eff * n + i_eff
        # maximum, not clamp: n is exactly 1 after the first step, and at a tie
        # the reference's gradient goes half to each side
        h_new = torch.sigmoid(o_t) * c / torch.maximum(n, n.new_ones(()))
        return (c, n, m_new, h_new), h_new

    if s > 1:
        (c_f, n_f, m_f, h_f), hs = chunked_scan(step, (c0, n0, m0, h0), pre.transpose(0, 1), chunk=128)
    else:
        (c_f, n_f, m_f, h_f), hs = scan(step, (c0, n0, m0, h0), pre.transpose(0, 1))
    y = hs.transpose(0, 1).to(x.dtype)

    # post-up-projection (pf = 4/3) GLU
    h_up = gelu(torch.einsum("bsd,de->bse", y, params["up_gate"])) * torch.einsum("bsd,de->bse", y, params["up"])
    out = torch.einsum("bse,ed->bsd", h_up, params["down"])
    return out, {"c": c_f, "n": n_f, "m": m_f, "h": h_f}


def slstm_state_init(cfg: ModelConfig, batch: int, *, device=None, lead: tuple[int, ...] = ()):
    shape = lead + (batch, cfg.d_model)
    zeros = lambda: torch.zeros(shape, dtype=torch.float32, device=device)  # noqa: E731
    return {"c": zeros(), "n": zeros(), "m": torch.full(shape, -1e30, dtype=torch.float32, device=device),
            "h": zeros()}
