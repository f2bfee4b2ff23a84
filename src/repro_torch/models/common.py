"""Shared model components: config dataclasses, initializers, norms, the
embedding with a sorted-scatter gradient, RoPE, activations, the chunked
scan and the heads. Counterpart of `repro.models.common`.

Parameters are nested dicts (and tuples) of tensors with the reference's
leaf names, nesting, shapes and dtypes. Every ``*_init`` takes a
`ParamInit`, which says where a leaf is made and with which leading (stack)
shape; every ``*_axes`` twin returns the logical-axis tuples of the same
tree.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import constrain, current_rules, tensor_parallel
from repro_torch.tree import tree_leaves, tree_map  # noqa: F401 (tree_map: callers import it from here too)

# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0           # DeepSeek-MoE shared experts (always active)
    d_expert: int = 0           # per-expert FFN width (fine-grained MoE)
    capacity_factor: float = 1.25
    router_scale: bool = False  # normalize top-k gate weights to sum 1


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer of the repeating pattern."""

    mixer: str                  # attn | swa | mamba | mlstm | slstm
    ffn: str = "mlp"            # mlp | moe | none
    window: int | None = None   # sliding window for swa mixers
    rope_theta: float | None = None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    pattern: tuple[LayerSpec, ...] = (LayerSpec("attn"),)
    # extra unrolled layers after the stacked periods (gemma3's 62 = 10*6 + 2)
    tail: tuple[LayerSpec, ...] = ()
    moe: MoEConfig | None = None
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    act: str = "swiglu"         # swiglu | gelu
    tie_embeddings: bool = True
    dtype: Any = torch.float32
    # ssm
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    # enc-dec (whisper): encoder layer count; frontend is a stub
    encoder_layers: int = 0
    encoder_frames: int = 0     # informational (input_specs decides)
    # multimodal stub: number of prefix embedding slots (llava patches)
    prefix_tokens: int = 0
    # numerics
    logit_softcap: float = 0.0

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_periods(self) -> int:
        if self.n_layers % len(self.pattern):
            raise ValueError(f"{self.name}: n_layers {self.n_layers} is not a multiple of the pattern "
                             f"({len(self.pattern)} layers)")
        return self.n_layers // len(self.pattern)

    @property
    def total_layers(self) -> int:
        return self.n_layers + len(self.tail)

    def param_count(self) -> int:
        """Exact parameter count, from the parameters made on the ``meta``
        device (nothing is allocated)."""
        from repro_torch.models.transformer import init_params  # cycle-free at call time

        params = init_params(None, self, device="meta")
        return sum(t.numel() for t in tree_leaves(params))


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamInit:
    """Where parameters are made: the generator (None draws from the global
    one; unused on ``meta``), the device, and the leading shape of a stacked
    leaf (the reference's per-period ``vmap`` of a layer's init)."""

    gen: torch.Generator | None
    device: torch.device
    lead: tuple[int, ...] = ()

    def stacked(self, n: int) -> "ParamInit":
        return dataclasses.replace(self, lead=(n,) + self.lead)

    def full(self, shape, value: float, dtype) -> torch.Tensor:
        return torch.full(self.lead + tuple(shape), value, dtype=dtype, device=self.device)

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """A constant leaf: ``t`` (made on this device) repeated over the
        leading shape."""
        return t.expand(self.lead + tuple(t.shape)).clone()


def dense_init(init: ParamInit, shape, dtype, scale: float | None = None) -> torch.Tensor:
    """Normal(0, scale) of ``init.lead + shape``, made in place in ``dtype``
    on the device (no float32 temporary). ``scale`` defaults to
    ``shape[0] ** -0.5`` as in the reference, whose ``fan_in`` is the first
    axis of the per-layer shape (``n_experts`` for the stacked expert
    weights)."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    s = scale if scale is not None else fan_in**-0.5
    t = torch.empty(init.lead + tuple(shape), dtype=dtype, device=init.device)
    if t.device.type != "meta":
        t.normal_(0.0, s, generator=init.gen)
    return t


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm_init(init: ParamInit, cfg: ModelConfig):
    return {"scale": init.full((cfg.d_model,), 1.0, cfg.dtype)}


def rmsnorm_axes():
    return {"scale": ("embed",)}


def rmsnorm(params, x, eps: float = 1e-6):
    """The square stays in x.dtype; only the mean accumulates in float32.
    Under sequence parallelism ``x`` is this rank's block of the sequence,
    so the scale's gradient is summed over the model ranks (it passes
    through `TensorParallel.copy_in`): each rank then holds the whole
    gradient, and the scale stays the same on every rank."""
    scale = params["scale"]
    tp = tensor_parallel()
    if tp is not None and tp.seq:
        scale = tp.copy_in(scale, "norm_scale")
    var = torch.mean(x.square(), dim=-1, keepdim=True, dtype=torch.float32)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * scale


# ---------------------------------------------------------------------------
# embedding with a sorted-scatter gradient
# ---------------------------------------------------------------------------


class _EmbedLookup(torch.autograd.Function):
    """``table[ids]``; the backward sorts the flat ids (stable) and adds the
    cotangent rows into a float32 table in that order, cast back to the
    table's dtype (the reference's custom VJP, `common.py:158-181`).

    The rows are added with ``index_put_(..., accumulate=True)``: on a card
    it sorts the indices (a stable radix sort) and adds each id's run of
    rows one after another, with no atomics, so the gradient repeats bit
    for bit as the reference's does. ``index_add_`` adds them with atomics
    there, in no fixed order. On the CPU both add in the ids' order.

    Under a rule table the reference skips the pre-sort (it would cost GSPMD
    an all-gather). Whether to sort is decided in ``forward``: the caller's
    thread holds the rule table, and a card's backward runs on autograd's
    own worker thread, which does not.

    ``table`` may be the block of rows ``[lo, lo + len(table))`` of the
    vocabulary (the model axis over ranks): an id outside it looks up a row
    of zeros, and in the backward adds a row of zeros (exact: the float32
    sums start from +0 and never hold -0), so that the rows of the ids
    inside keep their order and no host read picks them out."""

    @staticmethod
    def forward(ctx, table, ids, lo):
        ctx.table_shape, ctx.table_dtype = table.shape, table.dtype
        ctx.presort = current_rules() is None
        if lo is None:
            ctx.save_for_backward(ids)
            return table[ids]
        local = ids - lo
        inside = (local >= 0) & (local < table.shape[0])
        ctx.save_for_backward(local, inside)
        rows = table[local.clamp(0, table.shape[0] - 1)]
        return torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))

    @staticmethod
    def backward(ctx, g):
        v, d = ctx.table_shape
        flat_ids = ctx.saved_tensors[0].reshape(-1)
        flat_g = g.reshape(-1, d)
        if len(ctx.saved_tensors) > 1:  # a block: zeros for the ids outside it
            keep = ctx.saved_tensors[1].reshape(-1, 1)
            flat_ids = flat_ids.clamp(0, v - 1)
            flat_g = torch.where(keep, flat_g, torch.zeros((), dtype=flat_g.dtype, device=flat_g.device))
        if ctx.presort:
            order = torch.argsort(flat_ids, stable=True)
            flat_ids = flat_ids[order]
            flat_g = flat_g[order]
        dt = torch.zeros((v, d), dtype=torch.float32, device=g.device)
        dt.index_put_((flat_ids.long(),), flat_g.float(), accumulate=True)
        return dt.to(ctx.table_dtype), None, None


def embed_lookup(table, ids, vocab_size: int | None = None):
    """``table[ids]`` with the sorted-scatter backward. With ``vocab`` on
    the model axis over ranks, ``table`` is this rank's block of the
    ``vocab_size`` rows: each rank looks up its own ids (zeros for the
    others') and the rows are summed over the model ranks, exactly (one row
    and zeros)."""
    tp = tensor_parallel()
    if tp is None or not tp.splits("vocab"):
        return _EmbedLookup.apply(table, ids, None)
    if vocab_size is None:
        raise ValueError("an embedding split over the model ranks needs the whole vocabulary's size")
    lo, hi = tp.range(vocab_size)
    if hi - lo != table.shape[0]:
        raise ValueError(f"a block of {table.shape[0]} rows is not this rank's block [{lo}, {hi}) of the vocabulary "
                         f"of {vocab_size}")
    return tp.sum_out(_EmbedLookup.apply(table, ids, lo))


def embedding_init(init: ParamInit, cfg: ModelConfig):
    return {"table": dense_init(init, (cfg.vocab_size, cfg.d_model), cfg.dtype, scale=0.02)}


def embedding_axes():
    return {"table": ("vocab", "embed")}


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, positions):
    """positions: (..., S) int -> cos/sin (..., S, head_dim/2) float32."""
    half = head_dim // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=positions.device) / half)
    angles = positions.float()[..., None] * freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, cos, sin):
    """x: (B, S, H, D); cos/sin: (B, S, D/2) or (S, D/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.ndim == 2:
        cos_, sin_ = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos_, sin_ = cos[:, :, None, :], sin[:, :, None, :]
    y1 = x1 * cos_ - x2 * sin_
    y2 = x2 * cos_ + x1 * sin_
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# activations / scans / heads
# ---------------------------------------------------------------------------


def gelu(x):
    """`jax.nn.gelu`'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    if name == "gelu":
        return gelu
    if name == "silu":
        return F.silu
    raise ValueError(name)


def _scan(step, h, xs, lo: int, hi: int):
    """`lax.scan` of ``step`` over steps ``lo:hi`` of ``xs`` (a tensor or a
    tuple of tensors with a leading sequence axis); ys stacked on axis 0."""
    ys = []
    for t in range(lo, hi):
        h, y = step(h, tuple(a[t] for a in xs) if isinstance(xs, tuple) else xs[t])
        ys.append(y)
    return h, torch.stack(ys)


def scan(step, h0, xs):
    """`lax.scan` over the whole leading axis of ``xs``."""
    s = (xs[0] if isinstance(xs, tuple) else xs).shape[0]
    return _scan(step, h0, xs, 0, s)


def chunked_scan(step, h0, xs, *, chunk: int = 128):
    """The scan in chunks of ``chunk`` steps (halved until it divides the
    length); with grad on, each chunk runs under `torch.utils.checkpoint`, so
    only the carries at chunk boundaries are kept (the reference's
    sqrt-remat: O(S/chunk + chunk) carries instead of O(S))."""
    s = (xs[0] if isinstance(xs, tuple) else xs).shape[0]
    c = chunk
    while s % c:
        c //= 2
    c = max(c, 1)
    h, ys = h0, []
    for lo in range(0, s, c):
        if torch.is_grad_enabled():
            h, y = checkpoint(_scan, step, h, xs, lo, lo + c, use_reentrant=False)
        else:
            h, y = _scan(step, h, xs, lo, lo + c)
        ys.append(y)
    return h, torch.cat(ys)


def unembed(x, table):
    """Logits via the (tied) embedding table: (B,S,D) @ (V,D)^T. With
    ``vocab`` on the model axis over ranks, ``table`` is this rank's block
    of rows and the logits are that block's; under sequence parallelism
    ``x`` is this rank's block of the sequence, gathered whole here, so
    the logits cover the whole sequence."""
    tp = tensor_parallel()
    if tp is not None:
        x = tp.enter(x, tp.splits("vocab"))
    logits = torch.einsum("bsd,vd->bsv", x, table)
    return constrain(logits, "batch", None, "vocab")


def softcap(logits, cap: float):
    if not cap:
        return logits
    return cap * torch.tanh(logits / cap)
