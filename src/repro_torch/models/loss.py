"""LM loss: cross-entropy with float32 reductions, the z-loss, a mask and
the accuracy. Counterpart of `repro.models.loss`: the logsumexp accumulates
in float32 from the logits' own dtype, and the target logit is read without
materializing a float32 copy of the logits."""

from __future__ import annotations

import torch


def cross_entropy(logits, targets, mask=None, *, z_loss: float = 0.0):
    """logits: (B, S, V) any float dtype; targets: (B, S) int; mask: (B, S)
    {0,1}. Returns (mean_loss, metrics dict)."""
    m = logits.detach().amax(dim=-1).float()
    sum_exp = torch.sum(torch.exp(logits.float() - m[..., None]), dim=-1)
    lse = m + torch.log(sum_exp)

    target_logit = logits.gather(-1, targets[..., None].long()).squeeze(-1).float()

    nll = lse - target_logit
    if z_loss:
        nll = nll + z_loss * lse.square()

    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32, device=logits.device)
    mask = mask.float()
    denom = torch.clamp_min(mask.sum(), 1.0)
    loss = torch.sum(nll * mask) / denom

    acc = torch.sum((logits.argmax(-1) == targets) * mask) / denom
    return loss, {"loss": loss, "accuracy": acc, "tokens": denom}
