"""Pragma fixture: every seeded violation here is silenced inline — the
linter must record the findings as suppressed, never as active."""

import torch

from repro_torch.kernels import rng


def sample(key, shape):
    noise = rng.jax_normal(key, shape)
    init = rng.jax_uniform(key, shape)  # torchlint: disable=TL003
    return noise, init


@torch.compile
def loss(err):
    return err.sum().item()  # torchlint: disable=TL004
