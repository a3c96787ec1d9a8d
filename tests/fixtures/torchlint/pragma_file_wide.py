# torchlint: disable-file=TL003
"""File-wide pragma fixture: TL003 is disabled for the whole file, while
other rules stay live."""

from repro_torch.kernels import rng


def sample(key, shape):
    noise = rng.jax_normal(key, shape)
    init = rng.jax_uniform(key, shape)
    return noise, init
