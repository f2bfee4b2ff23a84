"""Model assembly: a decoder over stacked layer periods (+ an optional
encoder). Counterpart of `repro.models.transformer`.

One code path covers the ten architectures through the config's repeating
`pattern` of LayerSpecs:

  dense (starcoder2, phi3, llava-backbone):  (attn|mlp,)
  MoE (deepseek-moe, mixtral):               (attn|moe,) [+ SWA window]
  gemma3:                                    5x(swa|mlp) + 1x(attn|mlp)
  jamba:                                     8-period attn/mamba x moe/mlp
  xlstm:                                     7x(mlstm|none) + 1x(slstm|none)
  whisper:                                   encoder stack + (attn+cross|mlp)

Layer parameters are stacked over periods with the reference's leaf names
and shapes; the reference's scan is a loop over periods that slices every
leaf at period ``i``, and with ``remat`` and grad on each period runs under
`torch.utils.checkpoint` (the reference's ``jax.checkpoint``), its
recompute under the forward's rule table. With the model axis over ranks
(`distributed.tensor_parallel`) the layers hold and compute this rank's
block of the heads, the MLP width and the vocabulary: the embedding looks
up its block of rows (tied: the same block the head uses), and the logits
are this rank's block of the vocabulary. Decode
carries stacked per-period caches the same way; the decode state's
``index`` is a 0-d int32 tensor on the device, never read on the host.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import constrain, recompute_context, tensor_parallel
from repro_torch.distributed.sharding import map_axes as _map_axes
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models import xlstm as xl
from repro_torch.models.common import (
    LayerSpec,
    ModelConfig,
    ParamInit,
    dense_init,
    embed_lookup,
    embedding_axes,
    embedding_init,
    rmsnorm,
    rmsnorm_axes,
    rmsnorm_init,
    softcap,
    unembed,
)
from repro_torch.models.mlp import mlp_apply, mlp_axes, mlp_init
from repro_torch.models.moe import moe_apply, moe_axes, moe_init
from repro_torch.tree import tree_map

# ---------------------------------------------------------------------------
# per-layer init / axes
# ---------------------------------------------------------------------------


def _layer_init(init: ParamInit, cfg: ModelConfig, spec: LayerSpec, *, cross: bool):
    p = {"norm1": rmsnorm_init(init, cfg)}
    if spec.mixer in ("attn", "swa"):
        p["mixer"] = attn.attn_init(init, cfg)
    elif spec.mixer == "mamba":
        p["mixer"] = mb.mamba_init(init, cfg)
    elif spec.mixer == "mlstm":
        p["mixer"] = xl.mlstm_init(init, cfg)
    elif spec.mixer == "slstm":
        p["mixer"] = xl.slstm_init(init, cfg)
    else:
        raise ValueError(spec.mixer)
    if cross:
        p["norm_cross"] = rmsnorm_init(init, cfg)
        p["cross"] = attn.attn_init(init, cfg, cross=True)
    if spec.ffn == "mlp":
        p["norm2"] = rmsnorm_init(init, cfg)
        p["ffn"] = mlp_init(init, cfg)
    elif spec.ffn == "moe":
        p["norm2"] = rmsnorm_init(init, cfg)
        p["ffn"] = moe_init(init, cfg)
    return p


def _layer_axes(cfg: ModelConfig, spec: LayerSpec, *, cross: bool):
    ax = {"norm1": rmsnorm_axes()}
    if spec.mixer in ("attn", "swa"):
        ax["mixer"] = attn.attn_axes()
    elif spec.mixer == "mamba":
        ax["mixer"] = mb.mamba_axes()
    elif spec.mixer == "mlstm":
        ax["mixer"] = xl.mlstm_axes()
    elif spec.mixer == "slstm":
        ax["mixer"] = xl.slstm_axes()
    if cross:
        ax["norm_cross"] = rmsnorm_axes()
        ax["cross"] = attn.attn_axes()
    if spec.ffn == "mlp":
        ax["norm2"] = rmsnorm_axes()
        ax["ffn"] = mlp_axes(cfg)
    elif spec.ffn == "moe":
        ax["norm2"] = rmsnorm_axes()
        ax["ffn"] = moe_axes(cfg)
    return ax


def _stack_axes(tree):
    """Prepend the period 'stack' axis to every logical-axis tuple."""
    return _map_axes(lambda axes: ("stack",) + axes, tree)


# ---------------------------------------------------------------------------
# model init / axes
# ---------------------------------------------------------------------------


def _unembed_table(params):
    return params["lm_head"] if "lm_head" in params else params["embed"]["table"]


def init_params(gen, cfg: ModelConfig, *, device=None):
    """Parameters of ``cfg``, each leaf made in place in its dtype on
    ``device`` (default ``cuda``, which must exist; ``"meta"`` allocates
    nothing) from ``gen`` (a `torch.Generator` on that device)."""
    device = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    init = ParamInit(gen, device)
    cross = cfg.encoder_layers > 0
    params = {"embed": embedding_init(init, cfg), "final_norm": rmsnorm_init(init, cfg)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(init, (cfg.vocab_size, cfg.d_model), cfg.dtype, scale=0.02)
    # decoder stack: one stacked param tree per pattern position
    per_period = init.stacked(cfg.n_periods)
    params["layers"] = tuple(_layer_init(per_period, cfg, spec, cross=cross) for spec in cfg.pattern)
    if cfg.tail:
        params["tail"] = tuple(_layer_init(init, cfg, spec, cross=cross) for spec in cfg.tail)
    if cross:
        params["encoder"] = {
            "layers": _layer_init(init.stacked(cfg.encoder_layers), cfg, LayerSpec("attn", "mlp"), cross=False),
            "norm": rmsnorm_init(init, cfg),
        }
    return params


def param_axes(cfg: ModelConfig):
    cross = cfg.encoder_layers > 0
    ax = {"embed": embedding_axes(), "final_norm": rmsnorm_axes()}
    if not cfg.tie_embeddings:
        ax["lm_head"] = ("vocab", "embed")
    ax["layers"] = tuple(_stack_axes(_layer_axes(cfg, spec, cross=cross)) for spec in cfg.pattern)
    if cfg.tail:
        ax["tail"] = tuple(_layer_axes(cfg, spec, cross=cross) for spec in cfg.tail)
    if cross:
        ax["encoder"] = {
            "layers": _stack_axes(_layer_axes(cfg, LayerSpec("attn", "mlp"), cross=False)),
            "norm": rmsnorm_axes(),
        }
    return ax


# ---------------------------------------------------------------------------
# block apply
# ---------------------------------------------------------------------------


def _mixer_apply(p, x, spec: LayerSpec, cfg: ModelConfig, *, positions, cache, cache_index, causal):
    if spec.mixer in ("attn", "swa"):
        return attn.attention_apply(p, x, cfg=cfg, positions=positions, causal=causal, window=spec.window,
                                    rope_theta=spec.rope_theta, cache=cache, cache_index=cache_index)
    if spec.mixer == "mamba":
        return mb.mamba_apply(p, x, cfg, state=cache)
    if spec.mixer == "mlstm":
        return xl.mlstm_apply(p, x, cfg, state=cache)
    if spec.mixer == "slstm":
        return xl.slstm_apply(p, x, cfg, state=cache)
    raise ValueError(spec.mixer)


def _zero_aux(device):
    z = torch.zeros((), dtype=torch.float32, device=device)
    return (z, z)


def _block_apply(p, x, spec: LayerSpec, cfg: ModelConfig, *, positions, cache, cache_index, causal, enc_out):
    """Returns (x, new_cache, aux) with aux = (load_balance, dropped_frac)."""
    aux = _zero_aux(x.device)
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    mixer_out, new_cache = _mixer_apply(p["mixer"], h, spec, cfg, positions=positions, cache=cache,
                                        cache_index=cache_index, causal=causal)
    x = x + mixer_out
    if "cross" in p:
        hc = rmsnorm(p["norm_cross"], x, cfg.norm_eps)
        cross_out, _ = attn.attention_apply(p["cross"], hc, cfg=cfg, positions=positions, causal=False,
                                            kv_source=enc_out, use_rope=False)
        x = x + cross_out
    if "ffn" in p:
        h2 = rmsnorm(p["norm2"], x, cfg.norm_eps)
        if spec.ffn == "moe":
            y, aux = moe_apply(p["ffn"], h2, cfg)
            x = x + y
        else:
            x = x + mlp_apply(p["ffn"], h2, cfg)
    x = constrain(x, "batch", "seq", "embed")
    return x, new_cache, aux


def _period(tree, i: int):
    """Every leaf of a stacked tree at period ``i``."""
    return tree_map(lambda a: a[i], tree)


def _embed(params, tokens, cfg: ModelConfig):
    x = embed_lookup(params["embed"]["table"], tokens, cfg.vocab_size).to(cfg.dtype)
    if cfg.name.startswith("gemma"):
        # sqrt(d) rounded to the model's dtype first, as in the reference
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype).item()
    return x


def _head(params, x, cfg: ModelConfig):
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return softcap(unembed(x, _unembed_table(params)), cfg.logit_softcap)


# ---------------------------------------------------------------------------
# forward (train / prefill / encode)
# ---------------------------------------------------------------------------


def encode(params, frames, cfg: ModelConfig):
    """Whisper-style encoder over stub frame embeddings (B, F, d)."""
    f = frames.shape[1]
    pos = torch.arange(f, dtype=torch.int32, device=frames.device)
    x = frames + _sinusoidal(f, cfg.d_model, frames.dtype, frames.device)
    spec = LayerSpec("attn", "mlp")
    for i in range(cfg.encoder_layers):
        x, _, _ = _block_apply(_period(params["encoder"]["layers"], i), x, spec, cfg, positions=pos, cache=None,
                               cache_index=None, causal=False, enc_out=None)
    return rmsnorm(params["encoder"]["norm"], x, cfg.norm_eps)


def _sinusoidal(length, dim, dtype, device=None):
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    half = dim // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=device) / half)
    ang = pos * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)[None]


def forward(params, tokens, cfg: ModelConfig, *, prefix_embeddings=None, frames=None, remat: bool = True,
            aux: dict | None = None):
    """Training/prefill forward -> logits (B, S_total, V).

    prefix_embeddings: (B, P, d) multimodal stub prefix (llava patches).
    frames: (B, F, d) encoder stub input (whisper). With ``remat`` and grad
    on, each period is recomputed in the backward.
    """
    x = _embed(params, tokens, cfg)
    if prefix_embeddings is not None:
        x = torch.cat([prefix_embeddings.to(cfg.dtype), x], dim=1)
    x = constrain(x, "batch", "seq", "embed")

    enc_out = encode(params, frames, cfg) if frames is not None else None
    tp = tensor_parallel()
    if enc_out is not None and tp is not None and tp.splits("heads"):
        enc_out = tp.copy_in(enc_out)  # every cross-attention's part of its cotangent, summed over the ranks
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)

    def period_body(x, i):
        lps = _period(params["layers"], i)
        lb, dr = _zero_aux(x.device)
        for j, spec in enumerate(cfg.pattern):
            x, _, a = _block_apply(lps[j], x, spec, cfg, positions=positions, cache=None, cache_index=None,
                                   causal=True, enc_out=enc_out)
            lb, dr = lb + a[0], dr + a[1]
        return x, lb, dr

    lb_sum, dr_sum = _zero_aux(x.device)
    for i in range(cfg.n_periods):
        if remat and torch.is_grad_enabled():
            x, lb, dr = checkpoint(period_body, x, i, use_reentrant=False, context_fn=recompute_context)
        else:
            x, lb, dr = period_body(x, i)
        lb_sum, dr_sum = lb_sum + lb, dr_sum + dr
    for j, spec in enumerate(cfg.tail):
        x, _, a = _block_apply(params["tail"][j], x, spec, cfg, positions=positions, cache=None, cache_index=None,
                               causal=True, enc_out=enc_out)
        lb_sum, dr_sum = lb_sum + a[0], dr_sum + a[1]
    if aux is not None:
        n_moe = max(1, sum(1 for s in cfg.pattern if s.ffn == "moe") * cfg.n_periods
                    + sum(1 for s in cfg.tail if s.ffn == "moe"))
        aux["moe_load_balance"] = lb_sum / n_moe
        aux["moe_dropped_frac"] = dr_sum / n_moe
    return constrain(_head(params, x, cfg), "batch", None, "vocab")


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _cache_len(spec: LayerSpec, max_len: int) -> int:
    if spec.mixer == "swa" and spec.window:
        return min(max_len, spec.window)
    return max_len


def _one_cache(cfg: ModelConfig, spec: LayerSpec, batch: int, max_len: int, dtype, device, lead=()):
    if spec.mixer in ("attn", "swa"):
        return attn.make_cache(cfg, batch, _cache_len(spec, max_len), dtype, device=device, lead=lead)
    if spec.mixer == "mamba":
        return mb.mamba_state_init(cfg, batch, device=device, lead=lead)
    if spec.mixer == "mlstm":
        return xl.mlstm_state_init(cfg, batch, device=device, lead=lead)
    if spec.mixer == "slstm":
        return xl.slstm_state_init(cfg, batch, device=device, lead=lead)
    raise ValueError(spec.mixer)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, dtype, *, device=None):
    """Per-pattern-position stacked caches (leading dim = n_periods), plus
    unstacked caches for the tail layers, on ``device`` (default ``cuda``;
    ``"meta"`` allocates nothing)."""
    device = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    lead = (cfg.n_periods,)
    state = {
        "caches": tuple(_one_cache(cfg, spec, batch, max_len, dtype, device, lead) for spec in cfg.pattern),
        "index": torch.zeros((), dtype=torch.int32, device=device),
    }
    if cfg.tail:
        state["tail_caches"] = tuple(_one_cache(cfg, spec, batch, max_len, dtype, device) for spec in cfg.tail)
    return state


def _cache_axes(spec: LayerSpec):
    """Logical axes of one layer's cache, without the stack axis."""
    if spec.mixer in ("attn", "swa"):
        return {"k": ("batch", "kv_seq", "kv_heads", None), "v": ("batch", "kv_seq", "kv_heads", None),
                "pos": ("kv_seq",)}
    if spec.mixer == "mamba":
        return {"conv": ("batch", None, "mlp"), "ssm": ("batch", "mlp", None)}
    if spec.mixer == "mlstm":
        return {"c": ("batch", None, None, "mlp"), "n": ("batch", None, "mlp"), "m": ("batch", None),
                "conv": ("batch", None, "mlp")}
    if spec.mixer == "slstm":
        return {k: ("batch", "mlp") for k in ("c", "n", "m", "h")}
    raise ValueError(spec.mixer)


def decode_state_axes(cfg: ModelConfig):
    """Logical-axis tree mirroring init_decode_state."""
    out = {"caches": tuple(_stack_axes(_cache_axes(spec)) for spec in cfg.pattern), "index": ()}
    if cfg.tail:
        out["tail_caches"] = tuple(_cache_axes(spec) for spec in cfg.tail)
    return out


def _stack(trees):
    """One stacked tree from per-period trees of the same structure."""
    return tree_map(lambda *leaves: torch.stack(leaves), trees[0], *trees[1:])


def decode_step(params, state, tokens, cfg: ModelConfig, *, enc_out=None):
    """One decode step. tokens: (B, s), s typically 1 (s > 1: a block
    prefill). Returns (logits (B, s, V), new state); ``state`` is not
    changed. Layer order is period-major, as in forward()."""
    index = state["index"]
    s = tokens.shape[1]
    x = _embed(params, tokens, cfg)
    positions = index + torch.arange(s, dtype=torch.int32, device=x.device)

    new_caches = [[] for _ in cfg.pattern]
    for p in range(cfg.n_periods):
        lps = _period(params["layers"], p)
        for i, spec in enumerate(cfg.pattern):
            cache = _period(state["caches"][i], p)
            x, nc, _ = _block_apply(lps[i], x, spec, cfg, positions=positions, cache=cache, cache_index=index,
                                    causal=True, enc_out=enc_out)
            new_caches[i].append(nc if nc is not None else cache)

    new_state = {"caches": tuple(_stack(c) for c in new_caches), "index": index + s}
    if cfg.tail:
        tail_caches = []
        for j, spec in enumerate(cfg.tail):
            cache = state["tail_caches"][j]
            x, nc, _ = _block_apply(params["tail"][j], x, spec, cfg, positions=positions, cache=cache,
                                    cache_index=index, causal=True, enc_out=enc_out)
            tail_caches.append(nc if nc is not None else cache)
        new_state["tail_caches"] = tuple(tail_caches)
    return _head(params, x, cfg), new_state
