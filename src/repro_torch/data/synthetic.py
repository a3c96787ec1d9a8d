"""Synthetic token data for training (port of ``repro.data.synthetic``'s
``token_stream`` and the ``train`` kind of ``make_batch``).

Batches are drawn on the CPU from a ``torch.Generator``, so one seed gives
the same batches whichever device trains on them (the model moves the
tokens to its device).  The numbers differ from ``jax.random``'s: tests
that need both packages on one batch make it with numpy and hand it to
both.
"""

from __future__ import annotations

import torch


def token_stream(generator: torch.Generator, vocab_size: int, batch: int,
                 length: int) -> torch.Tensor:
    """Markov-ish synthetic tokens (not uniform — a learnable signal): about
    half the positions copy the token before them.  (batch, length) int32."""
    base = torch.randint(0, vocab_size, (batch, length), generator=generator,
                         dtype=torch.int32)
    rep = torch.rand((batch, length), generator=generator) < 0.5
    shifted = torch.roll(base, 1, dims=1)
    return torch.where(rep, shifted, base)


def make_batch(cfg, shape, generator: torch.Generator, kind: str | None = None):
    """A training batch for (arch, shape): ``{"tokens": (B, S+1) int32}``
    (the extra token is the last position's label).  Token-only
    architectures and the ``train`` kind, the ones the port trains."""
    kind = kind or shape.kind
    if kind != "train" or cfg.frontend:
        raise ValueError(f"the port makes token batches for training only "
                         f"(kind={kind!r}, frontend={cfg.frontend!r})")
    return {"tokens": token_stream(generator, cfg.vocab_size,
                                   shape.global_batch, shape.seq_len + 1)}
