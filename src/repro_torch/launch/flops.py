"""Analytic per-cell FLOP and byte model. Counterpart of
`repro.launch.flops`: plain arithmetic over a `ModelConfig`, exact matmul
MAC counts from the config.

Conventions (the reference's): flops count multiply+add (2 per MAC); a
train step is 4x the forward (forward, 2x backward, 1x remat forward); the
capacity-padded MoE compute is charged at the padded size
(``capacity_factor``). `launch.train` reports its model TFLOP/s as
``4 * forward_flops / step time``.
"""

from __future__ import annotations

from repro_torch.models.common import LayerSpec, ModelConfig


def _attn_flops_per_token(cfg: ModelConfig, spec: LayerSpec, s_ctx: float, *, cross_src: int = 0) -> float:
    hd = cfg.hd
    h, k = cfg.n_heads, cfg.n_kv_heads
    d = cfg.d_model
    proj = 2 * d * (h + 2 * k) * hd + 2 * h * hd * d
    if spec.window:
        s_eff = min(spec.window, s_ctx)
    else:
        s_eff = s_ctx
    attn = 2 * s_eff * h * hd * 2
    out = proj + attn
    if cross_src:
        out += 2 * d * h * hd + 2 * cross_src * h * hd * 2  # q proj + cross scores/av
    return out


def _ffn_flops_per_token(cfg: ModelConfig, spec: LayerSpec) -> float:
    d = cfg.d_model
    if spec.ffn == "mlp":
        mult = 3 if cfg.act == "swiglu" else 2
        return 2 * d * cfg.d_ff * mult
    if spec.ffn == "moe":
        m = cfg.moe
        de = m.d_expert or cfg.d_ff
        routed = 2 * d * de * 3 * m.top_k * m.capacity_factor
        shared = 2 * d * de * m.n_shared * 3
        router = 2 * d * m.n_experts
        return routed + shared + router
    return 0.0


def _mixer_flops_per_token(cfg: ModelConfig, spec: LayerSpec, s_ctx: float) -> float:
    d = cfg.d_model
    if spec.mixer in ("attn", "swa"):
        return _attn_flops_per_token(cfg, spec, s_ctx)
    if spec.mixer == "mamba":
        di = cfg.mamba_expand * d
        n = cfg.mamba_d_state
        dtr = max(1, d // 16)
        return (
            2 * d * 2 * di + 2 * cfg.mamba_d_conv * di + 2 * di * (dtr + 2 * n)
            + 2 * dtr * di + 6 * di * n + 2 * di * d + 4 * di
        )
    if spec.mixer == "mlstm":
        di = 2 * d
        hd = di // cfg.n_heads
        return 2 * d * 2 * di + 8 * di + 3 * 2 * di * hd + 7 * cfg.n_heads * hd * hd + 2 * di * d
    if spec.mixer == "slstm":
        fup = int(4 * d / 3)
        return 2 * d * 4 * d + 2 * d * 4 * d + 20 * d + 2 * d * fup * 2 + 2 * fup * d
    raise ValueError(spec.mixer)


def forward_flops(cfg: ModelConfig, *, n_tokens: float, s_ctx: float, enc_tokens: float = 0.0) -> float:
    """Total forward FLOPs for n_tokens decoder tokens at context s_ctx."""
    total = 0.0
    specs = list(cfg.pattern) * cfg.n_periods + list(cfg.tail)
    cross = cfg.encoder_layers > 0
    for spec in specs:
        per_tok = _mixer_flops_per_token(cfg, spec, s_ctx) + _ffn_flops_per_token(cfg, spec)
        if cross:
            per_tok += 2 * cfg.d_model * cfg.n_heads * cfg.hd * 2 + 2 * cfg.encoder_frames * cfg.n_heads * cfg.hd * 2
        total += per_tok * n_tokens
    # unembed
    total += 2 * cfg.d_model * cfg.vocab_size * n_tokens
    # encoder stack
    if cross and enc_tokens:
        enc_spec = LayerSpec("attn", "mlp")
        per_tok = _attn_flops_per_token(cfg, enc_spec, enc_tokens / 2) + 2 * cfg.d_model * cfg.d_ff * 2
        total += cfg.encoder_layers * per_tok * enc_tokens
    return total


def cell_costs(cfg: ModelConfig, shape, chips: int) -> dict:
    """Analytic per-chip flops and HBM bytes for a dry-run cell."""
    b, s = shape.global_batch, shape.seq_len
    params = cfg.param_count()
    p_chip = params / chips

    if shape.kind == "train":
        n_tokens = b * s
        fwd = forward_flops(cfg, n_tokens=n_tokens, s_ctx=s / 2, enc_tokens=b * cfg.encoder_frames)
        flops = 4.0 * fwd / chips  # fwd + 2x bwd + remat fwd
        # params: 3 reads (fwd/remat/bwd) bf16 + grads rw + adam fp32 rw
        param_bytes = p_chip * (3 * 2 + 2 * 2 + 3 * 4 * 2)
        act_bytes = 12.0 * n_tokens * cfg.d_model * 2 * cfg.total_layers / chips
        return {"flops": flops, "bytes": param_bytes + act_bytes}

    if shape.kind == "prefill":
        n_tokens = b * s
        fwd = forward_flops(cfg, n_tokens=n_tokens, s_ctx=s / 2, enc_tokens=b * cfg.encoder_frames)
        flops = fwd / chips
        param_bytes = p_chip * 2
        act_bytes = 6.0 * n_tokens * cfg.d_model * 2 * cfg.total_layers / chips
        return {"flops": flops, "bytes": param_bytes + act_bytes}

    # decode: one token per sequence against an s-long cache/state
    n_tokens = b
    fwd = forward_flops(cfg, n_tokens=n_tokens, s_ctx=s, enc_tokens=0.0)
    flops = fwd / chips
    # KV cache traffic: read the full cache (+tiny write) per step
    cache_bytes = 0.0
    specs = list(cfg.pattern) * cfg.n_periods + list(cfg.tail)
    for spec in specs:
        if spec.mixer in ("attn", "swa"):
            length = min(spec.window, s) if spec.window else s
            cache_bytes += b * length * cfg.n_kv_heads * cfg.hd * 2 * 2
        elif spec.mixer == "mamba":
            cache_bytes += b * 2 * cfg.d_model * cfg.mamba_d_state * 4 * 2
        elif spec.mixer == "mlstm":
            di = 2 * cfg.d_model
            hd = di // cfg.n_heads
            cache_bytes += b * cfg.n_heads * hd * hd * 4 * 2
        elif spec.mixer == "slstm":
            cache_bytes += b * 4 * cfg.d_model * 4 * 2
    bytes_ = p_chip * 2 + cache_bytes / chips + 4.0 * n_tokens * cfg.d_model * 2 * cfg.total_layers / chips
    return {"flops": flops, "bytes": bytes_}
