"""Synthetic data: token streams and frontend-embedding stubs (port of
``repro.data.synthetic``).

``make_batch`` returns real tensors (smoke tests, examples, the
launcher); ``make_specs`` returns tensors on the ``meta`` device in place
of the reference's ``ShapeDtypeStruct`` stand-ins, with the same shapes
and dtypes (the dry run: no memory, no device).

Batches are drawn on the CPU from a ``torch.Generator``, so one seed gives
the same batches whichever device trains on them (the model moves them to
its device).  The numbers differ from ``jax.random``'s: tests that need
both packages on one batch make it with numpy and hand it to both.

Frontend stubs, as in the reference: a vision or audio config's batches
carry precomputed embeddings ``(B, num_frontend_tokens, FRONTEND_DIM)`` in
float32, standing in for InternViT / EnCodec outputs, and the text is
``seq_len - num_frontend_tokens`` tokens long.
"""

from __future__ import annotations

import torch

from repro_torch.models.transformer import FRONTEND_DIM


def token_stream(generator: torch.Generator, vocab_size: int, batch: int,
                 length: int) -> torch.Tensor:
    """Markov-ish synthetic tokens (not uniform — a learnable signal): about
    half the positions copy the token before them.  (batch, length) int32."""
    base = torch.randint(0, vocab_size, (batch, length), generator=generator,
                         dtype=torch.int32)
    rep = torch.rand((batch, length), generator=generator) < 0.5
    shifted = torch.roll(base, 1, dims=1)
    return torch.where(rep, shifted, base)


def _text_len(cfg, shape) -> int:
    return shape.seq_len - (cfg.num_frontend_tokens if cfg.frontend else 0)


def make_batch(cfg, shape, generator: torch.Generator, kind: str | None = None):
    """Real tensors for an (arch, shape) pair; ``kind`` defaults to
    ``shape.kind``.  ``train``: ``{"tokens": (B, S_text + 1) int32}`` (the
    extra token is the last position's label); ``prefill``: ``(B,
    S_text)``; both with ``"frontend"`` for a frontend config.  ``decode``:
    ``{"tokens": (B, 1) int32, "cur_pos": seq_len - 1}``."""
    kind = kind or shape.kind
    B = shape.global_batch
    if kind in ("train", "prefill"):
        extra = 1 if kind == "train" else 0
        batch = {"tokens": token_stream(generator, cfg.vocab_size, B,
                                        _text_len(cfg, shape) + extra)}
        if cfg.frontend:
            batch["frontend"] = torch.randn(
                (B, cfg.num_frontend_tokens, FRONTEND_DIM), generator=generator)
        return batch
    if kind == "decode":
        return {"tokens": torch.randint(0, cfg.vocab_size, (B, 1),
                                        generator=generator, dtype=torch.int32),
                "cur_pos": shape.seq_len - 1}
    raise ValueError(kind)


def make_specs(cfg, shape, kind: str | None = None):
    """``make_batch``'s structure on the ``meta`` device (shapes and dtypes
    only; the dry run's inputs).  ``decode``'s ``cur_pos`` is the host int
    ``seq_len - 1``, as ``make_batch`` gives it: the decode step takes its
    position on the host."""
    kind = kind or shape.kind
    B = shape.global_batch
    meta = torch.device("meta")
    if kind in ("train", "prefill"):
        extra = 1 if kind == "train" else 0
        batch = {"tokens": torch.empty((B, _text_len(cfg, shape) + extra),
                                       dtype=torch.int32, device=meta)}
        if cfg.frontend:
            batch["frontend"] = torch.empty((B, cfg.num_frontend_tokens, FRONTEND_DIM),
                                            dtype=torch.float32, device=meta)
        return batch
    if kind == "decode":
        return {"tokens": torch.empty((B, 1), dtype=torch.int32, device=meta),
                "cur_pos": shape.seq_len - 1}
    raise ValueError(kind)
