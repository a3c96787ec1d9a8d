"""Seeded TL003 violations: one key consumed by two draws at the same
counters (in a row, round a loop, and after either branch), and draws from
the global generator."""

import torch

from repro_torch.kernels import rng


def sample(key, shape):
    noise = rng.jax_normal(key, shape)
    init = rng.jax_uniform(key, shape)  # expect: TL003
    return noise, init


def per_step(key, n, shape):
    out = []
    for _ in range(n):
        out.append(rng.jax_normal(key, shape))  # expect: TL003
    return out


def either(key, shape, flag):
    if flag:
        z = rng.jax_normal(key, shape)
    else:
        z = rng.jax_uniform(key, shape)
    return z + rng.jax_normal(key, shape)  # expect: TL003


def seeded(key, shape):
    gen = torch.Generator().manual_seed(rng.seed_int(key))
    again = torch.Generator().manual_seed(rng.seed_int(key))  # expect: TL003
    return torch.randn(shape, generator=gen), again


def init(shape):
    w = torch.randn(shape)  # expect: TL003
    b = torch.empty(shape)
    b.normal_()  # expect: TL003
    idx = torch.randint(  # expect: TL003
        0, 10,
        (3,))
    return w, b, idx
