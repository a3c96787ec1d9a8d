"""Synthetic data: token streams and frontend-embedding stubs (port of
``repro.data.synthetic``).

``make_batch`` returns real tensors (smoke tests, examples, the
launcher); ``make_specs`` returns tensors on the ``meta`` device in place
of the reference's ``ShapeDtypeStruct`` stand-ins, with the same shapes
and dtypes (the dry run: no memory, no device).

Batches are drawn from a PRNG key (:mod:`~repro_torch.kernels.rng`:
``split``, ``randint``, ``bernoulli`` as ``uniform < p``, and ``normal``)
on the device ``make_batch`` is given (the CPU by default; on a card the
uniforms and the frontend stubs' normals are the draw kernel's), so a key
gives the JAX package's batch bit for bit, whichever device draws it.

Frontend stubs, as in the reference: a vision or audio config's batches
carry precomputed embeddings ``(B, num_frontend_tokens, FRONTEND_DIM)`` in
float32, standing in for InternViT / EnCodec outputs, and the text is
``seq_len - num_frontend_tokens`` tokens long.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import rng
from repro_torch.models.transformer import FRONTEND_DIM


def token_stream(key, vocab_size: int, batch: int, length: int,
                 device="cpu") -> torch.Tensor:
    """Markov-ish synthetic tokens (not uniform — a learnable signal): about
    half the positions copy the token before them.  (batch, length) int32
    on ``device``, the reference's: ``k1, k2 = split(key)``, ``randint``
    under ``k1``, the copies where ``bernoulli(k2, 0.5)``."""
    k1, k2 = rng.split(rng.as_key(key))
    base = rng.randint(k1, batch * length, vocab_size, device).reshape(batch, length)
    rep = rng.jax_uniform(k2, (batch, length), device=device) < 0.5
    shifted = torch.roll(base, 1, dims=1)
    return torch.where(rep, shifted, base)


def _text_len(cfg, shape) -> int:
    return shape.seq_len - (cfg.num_frontend_tokens if cfg.frontend else 0)


def make_batch(cfg, shape, key, kind: str | None = None, device="cpu"):
    """Real tensors for an (arch, shape) pair from ``key`` (a PRNG key, or
    an int seed of one), the reference's numbers, drawn on ``device``;
    ``kind`` defaults to ``shape.kind``.  ``kf, kt = split(key)``.  ``train``: ``{"tokens": (B,
    S_text + 1) int32}`` (the extra token is the last position's label)
    from ``token_stream(kt)``; ``prefill``: ``(B, S_text)``; both with
    ``"frontend"`` (``normal(kf)``) for a frontend config.  ``decode``:
    ``{"tokens": (B, 1) int32 (randint under kt), "cur_pos": seq_len -
    1}``."""
    kind = kind or shape.kind
    B = shape.global_batch
    kf, kt = rng.split(rng.as_key(key))
    if kind in ("train", "prefill"):
        extra = 1 if kind == "train" else 0
        batch = {"tokens": token_stream(kt, cfg.vocab_size, B,
                                        _text_len(cfg, shape) + extra, device)}
        if cfg.frontend:
            batch["frontend"] = rng.jax_normal(
                kf, (B, cfg.num_frontend_tokens, FRONTEND_DIM), device)
        return batch
    if kind == "decode":
        return {"tokens": rng.randint(kt, B, cfg.vocab_size, device).reshape(B, 1),
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
