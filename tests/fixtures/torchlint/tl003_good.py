"""TL003 clean variants: the key is split (or folded) before every draw,
the repo's standard idiom; one stream drawn a block at a time at its own
counters; the two draws on separate paths; explicit generators."""

import torch

from repro_torch.kernels import rng


def sample(key, shape):
    k_noise, k_init = rng.split(key)
    noise = rng.jax_normal(k_noise, shape)
    init = rng.jax_uniform(k_init, shape)
    return noise, init


def per_step(key, step, shape):
    key = rng.fold_in(key, step)
    return rng.jax_normal(key, shape)


def chain(key, n, shape):
    out = []
    for _ in range(n):
        key, sub = rng.split(key)
        out.append(rng.jax_normal(sub, shape))
    return out


def blocks(key, n, shape):
    out = []
    for i in range(4):
        out.append(rng.jax_normal(key, shape, "cpu", i * n))
    return out + [rng.jax_normal(key, shape, start=4 * n)]


def either(key, shape, flag):
    if flag:
        return rng.jax_normal(key, shape)
    return rng.jax_uniform(key, shape)


def init(shape, gen):
    w = torch.randn(shape, generator=gen)
    b = torch.empty(shape).normal_(generator=gen)
    idx = torch.randint(
        0, 10, (3,),
        generator=gen)
    return w, b, idx
