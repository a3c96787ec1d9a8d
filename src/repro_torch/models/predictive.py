"""Bayesian model averaging over the chain bank (port of
``repro.models.predictive.bma_logits``)."""

from __future__ import annotations

import math

import torch


def bma_logits(per_chain_logits: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Bayesian-model-averaged next-token log-probabilities.

    Reduces per-chain logits ``(C, ..., V)`` to the log of the *mean* of the
    per-chain softmax distributions — the posterior-predictive token law of
    the chain bank — computed stably in log space, in fp32.
    """
    C = per_chain_logits.shape[axis]
    logp = torch.log_softmax(per_chain_logits.float(), dim=-1)
    return torch.logsumexp(logp, dim=axis) - math.log(C)
