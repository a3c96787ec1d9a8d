"""Bayesian model averaging over the chain bank, and the predict-fn
builders that adapt the models to
:class:`~repro_torch.cluster.serve.ServeEngine` (port of
``repro.models.predictive``).

A difference by design: the port's :data:`PredictFn` is **bank-form**,
``(params (C, ...), queries (Q, ...)) -> predictions (C, Q, ...)``, where
the reference's is one chain's forward, ``vmap``-ped over the bank by its
engine.  The chain axis is explicit everywhere in the port (the models are
bank-form already), so the builders return functions over the whole bank:
:func:`regression_predict` lifts the one-chain forward with
``torch.func.vmap``, :func:`mlp_predict` and
:func:`transformer_next_token_predict` call the bank-form models — the
transformer through :meth:`~repro_torch.models.transformer.Model.prefill`,
the entry point of the serving path.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch

from repro_torch.models.mlp import apply_mlp

PyTree = Any
#: bank-form forward: (params (C, ...), queries (Q, ...)) -> preds (C, Q, ...)
PredictFn = Callable[[PyTree, Any], torch.Tensor]


def bma_logits(per_chain_logits: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Bayesian-model-averaged next-token log-probabilities.

    Reduces per-chain logits ``(C, ..., V)`` to the log of the *mean* of the
    per-chain softmax distributions — the posterior-predictive token law of
    the chain bank — computed stably in log space, in fp32.
    """
    C = per_chain_logits.shape[axis]
    logp = torch.log_softmax(per_chain_logits.float(), dim=-1)
    return torch.logsumexp(logp, dim=axis) - math.log(C)


def regression_predict(reg) -> PredictFn:
    """Posterior-predictive of :class:`~repro_torch.core.potentials.
    PolyRegression`: queries are raw inputs ``z (Q,)``, predictions
    ``phi(z)·w + b`` of every chain, ``(C, Q)`` from a bank ``w (C, 5)``."""

    def predict(w, z):
        return reg.predict(w, reg.features(z))

    return torch.func.vmap(predict, in_dims=(0, None))


def mlp_predict(cfg) -> PredictFn:
    """Feed-forward block as a regression head: queries ``x (Q, d_model)``,
    predictions ``(C, Q, d_model)`` through the bank-form
    :func:`~repro_torch.models.mlp.apply_mlp` (weights ``(C, d, f)``)."""

    def predict(params, x):
        C = next(iter(params.values())).shape[0]
        return apply_mlp(params, x.expand(C, *x.shape), cfg)

    return predict


def transformer_next_token_predict(model) -> PredictFn:
    """Next-token logits through the serving path: queries are a prompt
    batch ``{"tokens": (Q, T)}``, predictions every chain's last-position
    logits ``(C, Q, V)`` in fp32 from :meth:`~repro_torch.models.
    transformer.Model.prefill` — averaging them over the chains is Bayesian
    model averaging over the bank."""

    def predict(params, batch):
        logits, _ = model.prefill(params, batch)  # (C, Q, 1, V)
        return logits[:, :, 0].float()

    return predict
