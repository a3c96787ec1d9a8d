"""The sampler-transform primitives behind the paper's read models (port of
``repro.samplers.transforms``: the delayed read, the gradient oracle, the
unfused noise-and-commit pair, the fused commit and the pipeline overlap;
the masked-batch, SVRG, stale-correction and SGHMC transforms come with a
later slice).

The fused commit draws its noise bit for bit as the JAX package does
(threefry in the kernel, keyed on the step's noise key).  The unfused
:func:`noise_like` draws from a ``torch.Generator`` seeded by each leaf's
key: the same law, not ``jax.random.normal``'s numbers.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Callable

import numpy as np
import torch

from repro_torch.core import delay as delay_lib
from repro_torch.kernels import rng
from repro_torch.kernels.ops import fused_langevin_update
from repro_torch.samplers.transform import SamplerTransform, StepContext, stateless
from repro_torch.utils import leaf_keys, tree_flatten, tree_map, tree_unflatten, tree_zeros_like

if TYPE_CHECKING:
    from repro_torch.samplers.policies import DelayPolicy

PyTree = Any
GradFn = Callable[..., PyTree]  # grad_fn(params, batch) -> grads | (grads, aux)


def langevin_scale(sigma: float, gamma) -> np.float32:
    """``sqrt(2 sigma gamma)`` in float32, rounded as the JAX package rounds
    ``jnp.sqrt(2.0 * sigma * gamma)``: ``2 sigma`` in double, then float32."""
    return np.sqrt(np.float32(2.0 * sigma) * np.float32(gamma))


# ---------------------------------------------------------------------------
# raw leafwise math
# ---------------------------------------------------------------------------
def noise_like(key, params: PyTree, scale, dtype) -> PyTree:
    """sqrt(2 sigma gamma) * G_k, one generator per leaf, seeded from the
    leaf's key (leaf order and keys as ``repro.samplers.transforms``)."""
    leaves, treedef = tree_flatten(params)
    out = []
    for k, p in zip(leaf_keys(key, leaves), leaves):
        gen = torch.Generator(device=p.device).manual_seed(rng.seed_int(k))
        z = torch.randn(p.shape, generator=gen, dtype=dtype, device=p.device)
        out.append((float(scale) * z).to(p.dtype))
    return tree_unflatten(treedef, out)


def sgld_apply(params: PyTree, grads: PyTree, gamma, noise: PyTree) -> PyTree:
    """x - gamma*g + noise, leafwise in each leaf's dtype (the fused path
    is :func:`fused_update`)."""

    def one(p, g, n):
        gm = torch.tensor(float(gamma), dtype=p.dtype, device=p.device)
        return (p - gm * g.to(p.dtype) + n).to(p.dtype)

    return tree_map(one, params, grads, noise)


# ---------------------------------------------------------------------------
# transform primitives
# ---------------------------------------------------------------------------
def gradients(grad_fn: GradFn, has_aux: bool = False) -> SamplerTransform:
    """Evaluate the gradient oracle at the (possibly stale) read point."""

    def update(ctx: StepContext) -> StepContext:
        out = grad_fn(ctx.x_hat, ctx.batch)
        grads, aux = out if has_aux else (out, None)
        return ctx._replace(grads=grads, aux=aux)

    return stateless(update)


def langevin_noise(sigma: float, schedule=None,
                   noise_dtype=torch.float32) -> SamplerTransform:
    """Draw the injected noise ``sqrt(2 sigma gamma_k) G_k`` into
    ``ctx.noise``; ``schedule`` optionally overrides ``gamma_k`` for the
    noise scale only."""

    def update(ctx: StepContext) -> StepContext:
        gamma = schedule(ctx.step) if schedule is not None else ctx.gamma
        return ctx._replace(noise=noise_like(ctx.key_noise, ctx.params,
                                             langevin_scale(sigma, gamma),
                                             noise_dtype))

    return stateless(update)


def apply_sgld_update() -> SamplerTransform:
    """Commit ``X_{k+1} = X_k - gamma_k grad + noise`` (unfused path)."""

    def update(ctx: StepContext) -> StepContext:
        if ctx.grads is None:
            raise ValueError("apply_sgld_update needs a gradients() stage first")
        noise = ctx.noise if ctx.noise is not None else tree_zeros_like(ctx.params)
        return ctx._replace(params=sgld_apply(ctx.params, ctx.grads, ctx.gamma, noise))

    return stateless(update)


def fused_update(sigma: float) -> SamplerTransform:
    """Commit through the fused Langevin kernel, **in place** on the
    parameters: the noise is made in the kernel from this step's noise key,
    and the update reads x and g once and writes x once — replacing the
    ``langevin_noise() + apply_sgld_update()`` pair on the hot path."""

    def update(ctx: StepContext) -> StepContext:
        if ctx.grads is None:
            raise ValueError("fused_update needs a gradients() stage first")
        params = fused_langevin_update(ctx.params, ctx.grads,
                                       rng.key_bits(ctx.key_noise), ctx.gamma,
                                       langevin_scale(sigma, ctx.gamma))
        return ctx._replace(params=params)

    return stateless(update)


def pipeline_overlap() -> SamplerTransform:
    """Swap this step's gradient for the previous one (tau=1 on the gradient
    sequence)."""

    def init(params):
        return tree_zeros_like(params)

    def update(ctx: StepContext, pending):
        if ctx.grads is None:
            raise ValueError("pipeline_overlap needs a gradients() stage first")
        return ctx._replace(grads=pending), ctx.grads

    return SamplerTransform(init, update)


def delay_read(policy: DelayPolicy) -> SamplerTransform:
    """Maintain the iterate ring buffer and set the stale read point.

    The last commit is pushed at the *start* of the step (value-identical to
    pushing at the end of the previous step)."""

    def init(params):
        return delay_lib.init_ring(params, policy.tau)

    def update(ctx: StepContext, ring):
        ring = delay_lib.push(ring, ctx.params)
        return ctx._replace(x_hat=policy.read(ctx, ring)), ring

    return SamplerTransform(init, update)
