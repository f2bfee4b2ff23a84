"""Mixture-of-Experts with Matrix-PIC sorted dispatch. Counterpart of
`repro.models.moe`.

This layer is the paper's co-design on the language-model side: token ->
expert assignments are the particles, experts the cells, and the
capacity-slot buffer the gapped binned layout.

  stage 1 (sort):    a stable counting sort of each sequence's assignments by
                     expert id, rank within expert (`core.binning.build_bins`)
  stage 2 (matrix):  each expert's dense FFN over its (C, d) slots, batched
                     over (B, E); gap slots are zero rows
  stage 3 (combine): each token gathers its top-k slot outputs weighted by
                     its router gates (the rhocell -> grid reduction)

Covers Mixtral (8 experts, top-2), DeepSeek-MoE (shared experts + 64
fine-grained, top-6) and Jamba (16 experts, top-2).

Over the model axis over ranks (`distributed.tensor_parallel`) the table
of `rules_for` puts ``experts`` on ``model`` where the model ranks divide
the expert count (expert parallelism: rank m holds the experts of its
`block_range`), else ``expert_mlp`` (tensor parallelism inside each
expert: every expert's columns of ``w_gate``/``w_up`` and rows of
``w_down`` in the rank's block), and the shared experts' width over
``mlp``. The router, stage 1 and the load-balance terms run replicated on
every model rank, so the capacity drop and the aux terms are the
one-process step's; each rank computes its part of the output (its
experts' slots, or its slice of every expert's width, plus its slice of
the shared experts), and one sum over the ranks ends the layer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import constrain, tensor_parallel
from repro_torch.models.common import ModelConfig, MoEConfig, ParamInit, dense_init


def moe_init(init: ParamInit, cfg: ModelConfig):
    m = cfg.moe
    d_e = m.d_expert or cfg.d_ff
    params = {
        "router": dense_init(init, (cfg.d_model, m.n_experts), torch.float32),
        "w_gate": dense_init(init, (m.n_experts, cfg.d_model, d_e), cfg.dtype),
        "w_up": dense_init(init, (m.n_experts, cfg.d_model, d_e), cfg.dtype),
        "w_down": dense_init(init, (m.n_experts, d_e, cfg.d_model), cfg.dtype),
    }
    if m.n_shared:
        params["shared"] = {
            "w_gate": dense_init(init, (cfg.d_model, d_e * m.n_shared), cfg.dtype),
            "w_up": dense_init(init, (cfg.d_model, d_e * m.n_shared), cfg.dtype),
            "w_down": dense_init(init, (d_e * m.n_shared, cfg.d_model), cfg.dtype),
        }
    return params


def moe_axes(cfg: ModelConfig):
    ax = {
        "router": ("fsdp", None),
        "w_gate": ("experts", "fsdp", "expert_mlp"),
        "w_up": ("experts", "fsdp", "expert_mlp"),
        "w_down": ("experts", "expert_mlp", "fsdp"),
    }
    if cfg.moe and cfg.moe.n_shared:
        ax["shared"] = {"w_gate": ("fsdp", "mlp"), "w_up": ("fsdp", "mlp"), "w_down": ("mlp", "fsdp")}
    return ax


def _capacity(n_tokens: int, m: MoEConfig) -> int:
    # a multiple of 256 above 256 slots (the reference shards it), else of 8
    c = int(n_tokens * m.top_k / m.n_experts * m.capacity_factor) + 1
    return max(8, ((c + 255) // 256) * 256) if c > 256 else max(8, ((c + 7) // 8) * 8)


def _dispatch_row(expert_ids_k, *, n_experts: int, cap: int, s: int, k: int):
    """Counting-sort dispatch of each sequence's S*k assignments, batched
    over the leading axis (the reference vmaps one sequence's).

    expert_ids_k: (B, S, k). Returns (slot_token (B, E*cap) int32: the token
    in each slot, ``s`` for a gap; a_slot (B, S*k) int32: each assignment's
    slot, ``E*cap`` where it was dropped; fits (B, S*k) bool)."""
    b = expert_ids_k.shape[0]
    dev = expert_ids_k.device
    a_expert = expert_ids_k.reshape(b, -1).long()                      # (B, S*k)
    a_token = torch.arange(s, dtype=torch.int32, device=dev).repeat_interleave(k)

    order = torch.argsort(a_expert, dim=-1, stable=True)               # key-only sort
    se = torch.gather(a_expert, 1, order)
    first = torch.searchsorted(se, se, side="left")
    rank = torch.arange(s * k, device=dev) - first
    fits_sorted = rank < cap

    dump = n_experts * cap
    dst = torch.where(fits_sorted, se * cap + rank, dump)

    slot_token = torch.full((b, n_experts * cap + 1), s, dtype=torch.int32, device=dev)
    slot_token = slot_token.scatter(1, dst, a_token[order])[:, :-1]
    a_slot = torch.zeros((b, s * k), dtype=torch.int32, device=dev).scatter(1, order, dst.int())
    fits = torch.zeros((b, s * k), dtype=torch.bool, device=dev).scatter(1, order, fits_sorted)
    return slot_token, a_slot, fits


def _local_slots(a_slot, lo: int, hi: int):
    """Each assignment's slot within the block ``[lo, hi)`` of slots,
    counted from 0; the block's zero row ``hi - lo`` for a slot outside it
    or a dropped assignment (slot ``E*cap``)."""
    inside = (a_slot >= lo) & (a_slot < hi)
    return torch.where(inside, a_slot - lo, hi - lo)


class _DispatchGather(torch.autograd.Function):
    """Stage 2's gather of the tokens into the binned buffer: ``x_ext[b,
    slot_token[b, j]]``, with ``x_ext`` the tokens and a zero row ``s`` for
    the gap slots.

    Its backward reads each token's gradient back through ``a_slot``: the
    cotangents of token t's k slots, added in k order, a dropped assignment
    (slot ``E*cap``) adding a zero row. That is a gather with no atomics,
    so it repeats bit for bit on a card. `torch.gather`'s own backward
    scatter-adds every slot into its token with atomics, up to k into one
    token and every gap into the zero row, in no fixed order."""

    @staticmethod
    def forward(ctx, x, slot_token, a_slot, k: int):
        b, _, d = x.shape
        ctx.save_for_backward(a_slot)
        ctx.k = k
        x_ext = torch.cat([x, x.new_zeros((b, 1, d))], dim=1)
        return torch.gather(x_ext, 1, slot_token.long()[..., None].expand(b, slot_token.shape[1], d))

    @staticmethod
    def backward(ctx, g):
        (a_slot,) = ctx.saved_tensors
        b, _, d = g.shape
        k = ctx.k
        g_ext = torch.cat([g, g.new_zeros((b, 1, d))], dim=1)
        picked = torch.gather(g_ext, 1, a_slot.long()[..., None].expand(b, a_slot.shape[1], d))
        picked = picked.reshape(b, a_slot.shape[1] // k, k, d)
        gx = picked[:, :, 0]
        for j in range(1, k):
            gx = gx + picked[:, :, j]
        return gx, None, None, None


def moe_apply(params, x, cfg: ModelConfig):
    """x: (B, S, d) -> (y (B, S, d), aux (load_balance, dropped_frac)).
    Sorted-dispatch, capacity-dropped MoE; the dispatch is per sequence, the
    expert compute batched over (B, E, C).

    Over the model ranks two inputs cross the *copy in* boundary: the ``x``
    that the dispatch and the shared experts read, and the gates where the
    combine reads them (each rank's combine sees its own part of the
    output, so each holds part of their cotangents). The router reads
    ``x`` itself: its cotangent is whole on every rank already, and the
    load-balance terms read the replicated softmax."""
    m = cfg.moe
    b, s, d = x.shape
    k = m.top_k
    cap = _capacity(s, m)
    tp = tensor_parallel()
    ep = tp is not None and tp.splits("experts")
    split = ep or (tp is not None and tp.splits("expert_mlp"))

    # --- router (per token), float32
    logits = torch.einsum("bsd,de->bse", x.float(), params["router"])
    gates_all = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(gates_all, k, dim=-1)          # descending
    if m.router_scale:
        gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)

    # --- stage 1: per-sequence counting sort into gapped expert bins
    slot_token, a_slot, fits = _dispatch_row(expert_ids, n_experts=m.n_experts, cap=cap, s=s, k=k)

    x_in = tp.copy_in(x) if split else x
    n_exp, slot_of = m.n_experts, a_slot
    if ep:  # this rank's experts: its block of slots, every other slot its zero row
        lo, hi = tp.range(m.n_experts)
        n_exp = hi - lo
        slot_token = slot_token[:, lo * cap:hi * cap]
        slot_of = _local_slots(a_slot, lo * cap, hi * cap)

    # --- stage 2: gather into the binned buffer (gap slots read a zero row)
    buf = _DispatchGather.apply(x_in, slot_token, slot_of, k)
    buf = buf.reshape(b, n_exp, cap, d)
    buf = constrain(buf, "batch", "experts", None, None)

    h = F.silu(torch.einsum("becd,edf->becf", buf, params["w_gate"])) * torch.einsum(
        "becd,edf->becf", buf, params["w_up"])
    h = constrain(h, "batch", "experts", None, "expert_mlp")
    out_buf = torch.einsum("becf,efd->becd", h, params["w_down"])
    out_buf = constrain(out_buf, "batch", "experts", None, None)

    # --- stage 3: weighted combine (the last row of out_flat is zero). The
    # gather's backward scatter-adds into out_flat, but each kept slot holds
    # one assignment: only the discarded zero row takes more than one add,
    # so the rows that are kept repeat bit for bit on a card.
    out_flat = torch.cat([out_buf.reshape(b, n_exp * cap, d), out_buf.new_zeros((b, 1, d))], dim=1)
    picked = torch.gather(out_flat, 1, slot_of.long()[..., None].expand(b, s * k, d)).reshape(b, s, k, d)
    gates = tp.copy_in(gate_vals) if split else gate_vals
    y = torch.sum(picked * gates[..., None].to(picked.dtype), dim=2)

    # --- shared experts (DeepSeek): dense path, always active
    if "shared" in params:
        sh = params["shared"]
        hs = F.silu(torch.einsum("bsd,df->bsf", x_in, sh["w_gate"])) * torch.einsum("bsd,df->bsf", x_in, sh["w_up"])
        y = y + torch.einsum("bsf,fd->bsd", hs, sh["w_down"])
    if split:  # every rank's part of the output, added in rank order
        y = tp.sum_out(y)

    # load-balance metrics (Switch-style aux loss ingredients); the counts
    # are a scatter-add, which needs no host read (a CUDA bincount does one)
    me = torch.mean(gates_all, dim=(0, 1))
    counts = torch.zeros(m.n_experts, dtype=torch.float32, device=x.device)
    counts.scatter_add_(0, expert_ids.reshape(-1), torch.ones(b * s * k, dtype=torch.float32, device=x.device))
    ce = counts / (b * s * k)
    load_balance = m.n_experts * torch.sum(me * ce)
    dropped = 1.0 - torch.sum(fits) / (b * s * k)

    return y, (load_balance, dropped)
