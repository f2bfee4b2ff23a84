"""LM loss: cross-entropy with float32 reductions, the z-loss, a mask and
the accuracy. Counterpart of `repro.models.loss`: the logsumexp accumulates
in float32 from the logits' own dtype, and the target logit is read without
materializing a float32 copy of the logits.

With ``vocab`` on the model axis over ranks (`distributed.tensor_parallel`)
the logits are this rank's block of the vocabulary, and the loss is
vocab-parallel: the max of each block gathered, the sums of exps added in
rank order, the target logit from the block that owns it (zeros from the
others, summed), the z-loss on the global logsumexp, and the accuracy's
argmax across the blocks with ties to the lowest global index, as
`torch.argmax` takes them. Every rank then holds the same loss."""

from __future__ import annotations

import torch

from repro_torch.distributed.sharding import tensor_parallel


def cross_entropy(logits, targets, mask=None, *, z_loss: float = 0.0, vocab_size: int | None = None):
    """logits: (B, S, V) any float dtype; targets: (B, S) int; mask: (B, S)
    {0,1}. Returns (mean_loss, metrics dict). ``vocab_size``: the whole
    vocabulary, of which ``logits`` hold this rank's block when the model
    axis over ranks splits it (else ``V``)."""
    tp = tensor_parallel()
    split = tp is not None and tp.splits("vocab")
    if split:
        if vocab_size is None:
            raise ValueError("a loss over logits split over the model ranks needs the whole vocabulary's size")
        lo, hi = tp.range(vocab_size)
        if hi - lo != logits.shape[-1]:
            raise ValueError(f"logits of {logits.shape[-1]} entries are not this rank's block [{lo}, {hi}) of the "
                             f"vocabulary of {vocab_size}")
    m = logits.detach().amax(dim=-1).float()
    if split:
        m = tp.gather(m, "loss_max").amax(dim=0)
    sum_exp = torch.sum(torch.exp(logits.float() - m[..., None]), dim=-1)
    if split:
        sum_exp = tp.sum_out(sum_exp)
    lse = m + torch.log(sum_exp)

    if split:
        local = targets.long() - lo
        inside = (local >= 0) & (local < hi - lo)
        picked = logits.gather(-1, local.clamp(0, hi - lo - 1)[..., None]).squeeze(-1).float()
        target_logit = tp.sum_out(torch.where(inside, picked, torch.zeros((), device=picked.device)))
    else:
        target_logit = logits.gather(-1, targets[..., None].long()).squeeze(-1).float()

    nll = lse - target_logit
    if z_loss:
        nll = nll + z_loss * lse.square()

    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32, device=logits.device)
    mask = mask.float()
    denom = torch.clamp_min(mask.sum(), 1.0)
    loss = torch.sum(nll * mask) / denom

    if split:
        with torch.no_grad():
            where = logits.argmax(-1)
            best = logits.gather(-1, where[..., None]).squeeze(-1)
            best, where = tp.gather(best, "argmax"), tp.gather(where + lo, "argmax")
            # the first rank holding the largest value holds its lowest index
            pred = where.gather(0, best.argmax(dim=0, keepdim=True)).squeeze(0)
    else:
        pred = logits.argmax(-1)
    acc = torch.sum((pred == targets) * mask) / denom
    return loss, {"loss": loss, "accuracy": acc, "tokens": denom}
