"""Attention: GQA/MQA with RoPE, an optional sliding window, the chunked
online-softmax (flash) attention for long blocks, and KV-cache decode.
Counterpart of `repro.models.attention`.

Scores and softmax are float32 whatever the inputs' dtype (the reference's
``preferred_element_type=float32``: the operands are upcast before the
product). The cache carries each slot's absolute position, so a full cache
and a sliding-window ring cache are one code path.

With the model axis over ranks (`distributed.sharding.tensor_parallel`)
and ``heads`` on it, a rank computes its block of the heads: q, k and v
column-parallel, ``wo`` row-parallel with a sum over the model ranks
after it (`TensorParallel.sum_out`). Where ``kv_heads`` stays replicated
(fewer kv heads than ranks, or a count the axis does not divide) each rank
projects the kv heads of its own q heads.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.sharding import constrain, tensor_parallel
from repro_torch.models.common import ModelConfig, ParamInit, apply_rope, dense_init, rope_frequencies

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def attn_init(init: ParamInit, cfg: ModelConfig, *, cross: bool = False):
    del cross  # cross-attention has the same projections
    hd = cfg.hd
    return {
        "wq": dense_init(init, (cfg.d_model, cfg.n_heads, hd), cfg.dtype),
        "wk": dense_init(init, (cfg.d_model, cfg.n_kv_heads, hd), cfg.dtype),
        "wv": dense_init(init, (cfg.d_model, cfg.n_kv_heads, hd), cfg.dtype),
        "wo": dense_init(init, (cfg.n_heads, hd, cfg.d_model), cfg.dtype),
    }


def attn_axes():
    return {
        "wq": ("fsdp", "heads", None),
        "wk": ("fsdp", "kv_heads", None),
        "wv": ("fsdp", "kv_heads", None),
        "wo": ("heads", None, "fsdp"),
    }


def _repeat_kv(k, n_rep: int):
    """Each kv head ``n_rep`` times in place (`jnp.repeat` interleaves)."""
    if n_rep == 1:
        return k
    return k.repeat_interleave(n_rep, dim=2)


def _acc_dtype(t) -> torch.dtype:
    """float32 for float32 and narrower inputs, float64 for float64."""
    return torch.promote_types(t.dtype, torch.float32)


# ---------------------------------------------------------------------------
# dense attention (short blocks) and chunked flash attention
# ---------------------------------------------------------------------------


def _mask_bias(q_pos, k_pos, *, causal: bool, window: int | None, dtype):
    """(Sq, Sk) additive bias from causality + sliding window."""
    d = q_pos[:, None] - k_pos[None, :]
    ok = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if causal:
        ok &= d >= 0
    if window is not None:
        ok &= d < window
    return torch.where(ok, 0.0, NEG_INF).to(dtype)


def dense_attention(q, k, v, *, q_pos, k_pos, causal: bool, window: int | None):
    """q: (B,Sq,H,D), k/v: (B,Sk,H,D) (kv already repeated). float32 softmax."""
    acc = _acc_dtype(q)
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * scale
    scores = scores + _mask_bias(q_pos, k_pos, causal=causal, window=window, dtype=acc)[None, None]
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)


def chunked_attention(q, k, v, *, q_pos, k_pos, causal: bool, window: int | None, q_chunk: int = 1024,
                      kv_chunk: int = 1024):
    """Flash-style exact attention with a flash backward: the forward saves
    only (q, k, v, out, lse); the backward recomputes each (q_chunk x
    kv_chunk) probability tile.

    The tile mask comes from the chunk offsets, valid because this path only
    runs with shift-invariant positions (self-attention prefill from the
    same base, or non-causal cross-attention), as in the reference.
    """
    del q_pos, k_pos
    q_chunk = _pick_chunk(q.shape[1], q_chunk)
    kv_chunk = _pick_chunk(k.shape[1], kv_chunk)
    return _FlashAttention.apply(q, k, v, causal, window, q_chunk, kv_chunk)


def _pick_chunk(n: int, target: int) -> int:
    """Largest divisor of n that is <= target (1500 -> 750 at target 1024)."""
    for c in range(min(target, n), 0, -1):
        if n % c == 0:
            return c
    return 1


def _tile_bias(qi, ki, q_chunk, kv_chunk, causal, window, dtype, device):
    """(q_chunk, kv_chunk) additive bias for tile (qi, ki)."""
    qpos = qi * q_chunk + torch.arange(q_chunk, device=device)
    kpos = ki * kv_chunk + torch.arange(kv_chunk, device=device)
    d = qpos[:, None] - kpos[None, :]
    ok = torch.ones(d.shape, dtype=torch.bool, device=device)
    if causal:
        ok &= d >= 0
    if window is not None:
        ok &= d < window
    return torch.where(ok, 0.0, NEG_INF).to(dtype)


def _flash_fwd_impl(causal, window, q_chunk, kv_chunk, q, k, v):
    b, sq, h, d = q.shape
    sk = k.shape[1]
    acc_dt = _acc_dtype(q)
    scale = d**-0.5
    outs, lses = [], []
    for qi in range(sq // q_chunk):
        qq = q[:, qi * q_chunk:(qi + 1) * q_chunk].to(acc_dt)
        m = torch.full((b, h, q_chunk), NEG_INF, dtype=acc_dt, device=q.device)
        l = torch.zeros((b, h, q_chunk), dtype=acc_dt, device=q.device)
        acc = torch.zeros((b, h, q_chunk, d), dtype=acc_dt, device=q.device)
        for ki in range(sk // kv_chunk):
            kk = k[:, ki * kv_chunk:(ki + 1) * kv_chunk].to(acc_dt)
            vv = v[:, ki * kv_chunk:(ki + 1) * kv_chunk].to(acc_dt)
            s = torch.einsum("bqhd,bkhd->bhqk", qq, kk) * scale
            s = s + _tile_bias(qi, ki, q_chunk, kv_chunk, causal, window, acc_dt, q.device)[None, None]
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vv)
            m = m_new
        l_safe = torch.clamp_min(l, 1e-30)
        outs.append((acc / l_safe[..., None]).transpose(1, 2).to(q.dtype))  # (B,qc,H,D)
        lses.append(m + torch.log(l_safe))                                 # (B,H,qc)
    return torch.cat(outs, dim=1), torch.cat(lses, dim=-1)


def _flash_bwd_impl(causal, window, q_chunk, kv_chunk, q, k, v, out, lse, g):
    b, sq, h, d = q.shape
    sk = k.shape[1]
    acc_dt = _acc_dtype(q)
    scale = d**-0.5
    nq, nk = sq // q_chunk, sk // kv_chunk
    # delta = rowsum(dout * out): (B, Sq, H) -> (B, H, Sq)
    delta = torch.sum(g.to(acc_dt) * out.to(acc_dt), dim=-1).transpose(1, 2)
    dq = torch.zeros((b, sq, h, d), dtype=acc_dt, device=q.device)
    dks, dvs = [], []
    for ki in range(nk):
        kk = k[:, ki * kv_chunk:(ki + 1) * kv_chunk].to(acc_dt)
        vv = v[:, ki * kv_chunk:(ki + 1) * kv_chunk].to(acc_dt)
        dk_acc = torch.zeros((b, kv_chunk, h, d), dtype=acc_dt, device=q.device)
        dv_acc = torch.zeros_like(dk_acc)
        for qi in range(nq):
            rows = slice(qi * q_chunk, (qi + 1) * q_chunk)
            qq, gg = q[:, rows].to(acc_dt), g[:, rows].to(acc_dt)
            s = torch.einsum("bqhd,bkhd->bhqk", qq, kk) * scale
            s = s + _tile_bias(qi, ki, q_chunk, kv_chunk, causal, window, acc_dt, q.device)[None, None]
            p = torch.exp(s - lse[..., rows][..., None])                   # (B,H,qc,kc)
            dp = torch.einsum("bqhd,bkhd->bhqk", gg, vv)
            ds = p * (dp - delta[..., rows][..., None]) * scale
            dv_acc = dv_acc + torch.einsum("bhqk,bqhd->bkhd", p, gg)
            dk_acc = dk_acc + torch.einsum("bhqk,bqhd->bkhd", ds, qq)
            dq[:, rows] += torch.einsum("bhqk,bkhd->bqhd", ds, kk)
        dks.append(dk_acc)
        dvs.append(dv_acc)
    return dq.to(q.dtype), torch.cat(dks, dim=1).to(k.dtype), torch.cat(dvs, dim=1).to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """The reference's `_flash_attention` custom VJP (`attention.py:118-216`)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_chunk, kv_chunk):
        out, lse = _flash_fwd_impl(causal, window, q_chunk, kv_chunk, q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.tiles = (causal, window, q_chunk, kv_chunk)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_impl(*ctx.tiles, q, k, v, out, lse, g)
        return dq, dk, dv, None, None, None, None


# ---------------------------------------------------------------------------
# layer-level apply (projections + rope + cache handling)
# ---------------------------------------------------------------------------


def _cache_write(t, new, start, dim: int):
    """`lax.dynamic_update_slice` of ``new`` into ``t`` at ``start`` along
    ``dim``: the start is a device tensor, already clamped so the block fits
    (the reference's update clamps it the same way; it never wraps)."""
    idx = start + torch.arange(new.shape[dim], device=t.device)
    return t.index_copy(dim, idx, new.to(t.dtype))


def attention_apply(
    params,
    x,
    *,
    cfg: ModelConfig,
    positions,
    causal: bool = True,
    window: int | None = None,
    rope_theta: float | None = None,
    cache: dict | None = None,
    cache_index=None,
    kv_source=None,
    use_rope: bool = True,
    chunked_threshold: int = 1024,
):
    """General attention layer.

    cache: {"k": (B, S_cache, KV, D), "v": ..., "pos": (S_cache,)} updated at
    cache_index (a device tensor) when decoding. kv_source: encoder states
    for cross-attention (no cache, not causal); with the heads on the model
    axis over ranks, states the caller passed through
    `TensorParallel.copy_in` once for all the layers that read them (so
    that their cotangents add in the one-process order before the sum over
    the ranks). Returns (out, new_cache).
    """
    b, s, _ = x.shape
    hd = cfg.hd
    n_rep = cfg.n_heads // cfg.n_kv_heads

    wk, wv = params["wk"], params["wv"]
    tp = tensor_parallel()
    split = tp is not None and tp.splits("heads")
    pick = None
    if split:
        # column-parallel over this rank's q heads; the replicated inputs'
        # cotangents add over the model ranks
        if cache is not None:
            raise ValueError("attention over the model ranks runs the training forward, not a cached decode")
        x = tp.copy_in(x)
        if not tp.splits("kv_heads"):
            # every rank holds every kv head: project those of its q heads;
            # the kv weights' gradients add over the model ranks
            h0, h1 = tp.range(cfg.n_heads)
            lo, hi = h0 // n_rep, (h1 - 1) // n_rep + 1
            wk, wv = tp.copy_in(wk)[:, lo:hi], tp.copy_in(wv)[:, lo:hi]
            pick = (h0 - lo * n_rep, h1 - lo * n_rep)

    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    src = x if kv_source is None else kv_source
    k = torch.einsum("bsd,dhk->bshk", src, wk)
    v = torch.einsum("bsd,dhk->bshk", src, wv)
    q = constrain(q, "batch", None, "heads", None)
    k = constrain(k, "batch", None, "kv_heads", None)

    theta = rope_theta if rope_theta is not None else cfg.rope_theta
    if use_rope and kv_source is None:
        cos_q, sin_q = rope_frequencies(hd, theta, positions)
        q = apply_rope(q, cos_q, sin_q)
        k = apply_rope(k, cos_q, sin_q)

    new_cache = None
    if cache is not None:
        ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
        cache_len = ck.shape[1]
        if s >= cache_len:
            # a block at least as long as the cache keeps its last entries
            ck = k[:, -cache_len:].to(ck.dtype)
            cv = v[:, -cache_len:].to(cv.dtype)
            cpos = positions[-cache_len:].to(cpos.dtype)
        else:
            slot = torch.as_tensor(cache_index, device=ck.device) % cache_len
            start = torch.clamp(slot, max=cache_len - s)
            ck = _cache_write(ck, k, start, 1)
            cv = _cache_write(cv, v, start, 1)
            cpos = _cache_write(cpos, positions, start, 0)
        new_cache = {"k": ck, "v": cv, "pos": cpos}
        if s > 1:
            # a block (prefill) attends within itself; the cache is taken
            # to be empty before it, as in the reference
            k_full, v_full, k_pos_eff = k, v, positions
        else:
            k_full, v_full, k_pos_eff = ck, cv, cpos
    else:
        k_full, v_full = k, v
        # cross-attention keys are indexed by the source sequence
        k_pos_eff = positions if kv_source is None else torch.arange(kv_source.shape[1], device=x.device)

    k_rep = _repeat_kv(k_full, n_rep)
    v_rep = _repeat_kv(v_full, n_rep)
    if pick is not None:
        k_rep, v_rep = k_rep[:, :, pick[0]:pick[1]], v_rep[:, :, pick[0]:pick[1]]

    sk = k_rep.shape[1]
    if s > 1 and max(s, sk) > chunked_threshold:
        # self-attention prefill or cross-attention: the flash path
        out = chunked_attention(q, k_rep, v_rep, q_pos=positions, k_pos=k_pos_eff,
                                causal=causal and kv_source is None, window=window)
    else:
        out = dense_attention(q, k_rep, v_rep, q_pos=positions, k_pos=k_pos_eff,
                              causal=causal and kv_source is None, window=window)

    out = constrain(out, "batch", None, "heads", None)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    if split:  # row-parallel: every rank's partial sum over its heads
        y = tp.sum_out(y)
    return y, new_cache


def make_cache(cfg: ModelConfig, batch: int, length: int, dtype, *, device=None, lead: tuple[int, ...] = ()):
    """KV cache with per-slot absolute positions (sentinel 2**30 = unwritten);
    ``lead`` prepends a stack axis (one cache a period)."""
    hd = cfg.hd
    return {
        "k": torch.zeros(lead + (batch, length, cfg.n_kv_heads, hd), dtype=dtype, device=device),
        "v": torch.zeros(lead + (batch, length, cfg.n_kv_heads, hd), dtype=dtype, device=device),
        "pos": torch.full(lead + (length,), 2**30, dtype=torch.int32, device=device),
    }
