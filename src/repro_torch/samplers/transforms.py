"""The sampler-transform primitives behind the sampler zoo (port of
``repro.samplers.transforms``): the delayed read, the gradient oracles
(plain, per-example over a bucket-padded :class:`MaskedBatch`, SVRG), the
batch-scaled step size, the stale-gradient correction, the unfused
noise-and-commit pair, the SGHMC commit, the fused commit and the pipeline
overlap.

The fused commit draws its noise bit for bit as the JAX package does
(threefry in the kernel, keyed on the step's noise key).  The unfused
:func:`noise_like` draws from a ``torch.Generator`` seeded by each leaf's
key by default: the same law, not ``jax.random.normal``'s numbers;
``noise="jax"`` draws ``jax.random.normal``'s numbers
(:func:`~repro_torch.kernels.rng.jax_normal`, many small torch ops a
leaf: meant for small chains).

Every update takes C chains stacked on a leading axis
(:mod:`repro_torch.samplers.transform`; C = 1 for a single chain): the
read and the fused commit are one kernel launch a leaf for all chains,
the elementwise stages one pass a leaf with each chain's scalars
broadcast over its row, and the gradient oracles and the unfused noise
draws one call a chain.  Chain c's result does not depend on C.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import delay as delay_lib
from repro_torch.kernels import rng
from repro_torch.kernels.ops import fused_langevin_update
from repro_torch.samplers.transform import (
    SamplerTransform,
    StepContext,
    chain_at,
    stack_chains,
    stateless,
)
from repro_torch.utils import (
    block_slices,
    is_placed,
    leaf_keys,
    place_like,
    to_device,
    tree_flatten,
    tree_leaves,
    tree_map,
    tree_unflatten,
    tree_zeros_like,
)

if TYPE_CHECKING:
    from repro_torch.samplers.policies import DelayPolicy

PyTree = Any
GradFn = Callable[..., PyTree]  # grad_fn(params, batch) -> grads | (grads, aux)
NOISE = ("torch", "jax")


class MaskedBatch(NamedTuple):
    """A bucket-padded minibatch view: ``data`` leaves carry a leading
    bucket axis of ``B >= size`` examples, of which only the first ``size``
    are real.  The executor pads every commit's window up a bucket ladder,
    and :func:`masked_gradients` averages over exactly the real examples,
    so padding rows never touch the math."""

    data: Any   # tree; leaves (B, ...) bucket-padded examples
    size: int   # count of real examples (<= B)


def batch_mask(batch: MaskedBatch) -> torch.Tensor:
    """(B,) float32 indicator of the real examples in a padded view."""
    leaf = tree_leaves(batch.data)[0]
    return (torch.arange(leaf.shape[0], device=leaf.device)
            < int(batch.size)).to(torch.float32)


def masked_mean(values: PyTree, size) -> PyTree:
    """Mean of the first ``size`` rows of every ``(B, ...)`` leaf: the sum
    of the rows times a 0/1 mask, over ``size`` in the leaf's dtype."""

    def reduce(v):
        mask = (torch.arange(v.shape[0], device=v.device) < int(size)).to(v.dtype)
        mask = mask.reshape((-1,) + (1,) * (v.dim() - 1))
        return torch.sum(v * mask, dim=0) / torch.tensor(float(int(size)),
                                                         dtype=v.dtype)

    return tree_map(reduce, values)


def langevin_scale(sigma: float, gamma) -> np.float32:
    """``sqrt(2 sigma gamma)`` in float32, rounded as the JAX package rounds
    ``jnp.sqrt(2.0 * sigma * gamma)``: ``2 sigma`` in double, then float32."""
    return np.sqrt(np.float32(2.0 * sigma) * np.float32(gamma))


def _chain_scalars(values, tree: PyTree) -> torch.Tensor:
    """C per-chain float32 values as a ``(C,)`` tensor on ``tree``'s
    device: one copy a commit, which does not stall the host."""
    return to_device(np.asarray(values, np.float32), tree_leaves(tree)[0].device)


def _rows(values: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``(C,)`` per-chain values in ``like``'s dtype, shaped to broadcast
    over the rows of ``like`` ``(C, ...)``."""
    return values.to(like.dtype).reshape(-1, *([1] * (like.dim() - 1)))


# ---------------------------------------------------------------------------
# raw leafwise math
# ---------------------------------------------------------------------------
def noise_like(key, params: PyTree, scale, dtype, noise: str = "torch") -> PyTree:
    """One chain's sqrt(2 sigma gamma) * G_k, one draw per leaf under the leaf's key
    (leaf order and keys as ``repro.samplers.transforms``): a
    ``torch.Generator`` seeded from it (``noise="torch"``), or
    ``jax.random.normal`` under it in float32 (``noise="jax"``), the JAX
    package's numbers.

    A placed leaf (a ``DTensor``, a chain split over the ``model`` axis)
    draws only its block of the whole leaf's ``jax.random.normal``, each
    element at its counter in the whole (:func:`~repro_torch.kernels.rng.
    jax_normal`'s ``block``), and comes back placed as the leaf is: the
    rank's block of the unplaced draw, bit for bit.  ``noise="torch"`` is
    refused there: a ``torch.Generator`` cannot start at a block's
    counters, and drawing the whole leaf on every rank is what placement
    avoids."""
    if noise not in NOISE:
        raise ValueError(f"noise must be one of {NOISE}, got {noise!r}")
    leaves, treedef = tree_flatten(params)
    out = []
    for k, p in zip(leaf_keys(key, leaves), leaves):
        if p.device.type == "meta":  # shapes only (the dry run): nothing to draw
            out.append(torch.empty_like(p))
            continue
        if is_placed(p):
            if noise != "jax":
                raise ValueError(
                    f"noise={noise!r} on a placed leaf: a torch.Generator cannot draw "
                    "a block of a leaf at the whole leaf's counters; pass noise='jax' "
                    "(each rank draws its block of jax.random.normal's numbers)")
            loc = p.to_local()
            z = rng.jax_normal(k, tuple(p.shape), loc.device,
                               block=block_slices(p.shape, p.device_mesh, p.placements))
            out.append(place_like((torch.tensor(np.float32(scale)) * z).to(loc.dtype), p))
            continue
        if noise == "jax":
            z = rng.jax_normal(k, p.shape, p.device)
            out.append((torch.tensor(np.float32(scale)) * z).to(p.dtype))
            continue
        gen = torch.Generator(device=p.device).manual_seed(rng.seed_int(k))
        z = torch.randn(p.shape, generator=gen, dtype=dtype, device=p.device)
        out.append((float(scale) * z).to(p.dtype))
    return tree_unflatten(treedef, out)


def sgld_apply(params: PyTree, grads: PyTree, gamma, noise: PyTree) -> PyTree:
    """x - gamma*g + noise of C chain-stacked chains, leafwise in each
    leaf's dtype, chain c's ``gamma[c]`` broadcast over its row (the fused
    path is :func:`fused_update`)."""
    gammas = _chain_scalars(gamma, params)
    return tree_map(lambda p, g, n: (p - _rows(gammas, p) * g.to(p.dtype) + n)
                    .to(p.dtype), params, grads, noise)


# ---------------------------------------------------------------------------
# transform primitives
# ---------------------------------------------------------------------------
def _per_chain_grads(C: int, oracle: Callable[[int], tuple]) -> tuple:
    """``oracle(c) -> (grads, aux)`` for every chain, stacked: one chain's
    gradient is viewed; C > 1 chains' are copied into one chain-stacked
    tree as they come (only one chain's activations and loose gradient
    live at a time).  Returns ``(grads, aux)``."""
    grads, auxs = None, []
    for c in range(C):
        g, aux = oracle(c)
        auxs.append(aux)
        if C == 1:
            return stack_chains([g]), stack_chains(auxs)
        if grads is None:
            grads = tree_map(lambda t: t.new_empty((C, *t.shape)), g)
        tree_map(lambda dst, src, c=c: dst[c].copy_(src), grads, g)
        del g
    return grads, stack_chains(auxs)


def gradients(grad_fn: GradFn, has_aux: bool = False) -> SamplerTransform:
    """Evaluate the gradient oracle at every chain's (possibly stale) read
    point: one oracle call a chain."""

    def update(ctx: StepContext) -> StepContext:
        def oracle(c):
            out = grad_fn(chain_at(ctx.x_hat, c), ctx.batch[c])
            return out if has_aux else (out, None)

        grads, aux = _per_chain_grads(len(ctx.batch), oracle)
        return ctx._replace(grads=grads, aux=aux)

    return stateless(update)


def _vmap_oracle(grad_fn: GradFn, params: PyTree, data):
    """``grad_fn(params, example)`` over the leading bucket axis of
    ``data`` with ``torch.func.vmap``.  An oracle that differentiates with
    ``torch.autograd.grad`` or ``backward`` (the port's potentials'
    ``grad``) cannot be vmapped: give an analytic per-example gradient."""
    try:
        return torch.func.vmap(lambda e: grad_fn(params, e))(data)
    except RuntimeError as e:
        if "functorch transform" not in str(e):
            raise
        raise TypeError(
            "a per-example oracle under MaskedBatch is vmapped with "
            "torch.func.vmap, which cannot batch torch.autograd.grad / "
            "backward: give an analytic per-example gradient") from e


def _oracle_grads(grad_fn: GradFn, params: PyTree, batch: Any, has_aux: bool):
    """Evaluate ``grad_fn`` at ``params`` under either batch contract: a
    plain batch calls the oracle once; a :class:`MaskedBatch` vmaps the
    *per-example* oracle over the padded bucket axis and masked-mean
    reduces, as :func:`masked_gradients` does.  Returns ``(grads, aux)``
    (aux ``None`` without ``has_aux``)."""
    if isinstance(batch, MaskedBatch):
        out = _vmap_oracle(grad_fn, params, batch.data)
        per_grads, per_aux = out if has_aux else (out, None)
        grads = masked_mean(per_grads, batch.size)
        aux = masked_mean(per_aux, batch.size) if has_aux else None
        return grads, aux
    out = grad_fn(params, batch)
    return out if has_aux else (out, None)


def masked_gradients(grad_fn: GradFn, has_aux: bool = False) -> SamplerTransform:
    """Evaluate a *per-example* gradient oracle over a :class:`MaskedBatch`.

    ``grad_fn(params, example)`` is vmapped (``torch.func.vmap``) over the
    padded bucket axis and reduced with :func:`masked_mean`, so the
    committed gradient averages exactly the ``size`` real examples however
    far the bucket ladder padded the view.  With ``has_aux`` the
    per-example aux is reduced the same way.  The oracle must be
    vmappable: an analytic gradient, not ``torch.autograd.grad`` (which
    raises a ``TypeError`` here).
    """

    def update(ctx: StepContext) -> StepContext:
        if not all(isinstance(b, MaskedBatch) for b in ctx.batch):
            raise TypeError("masked_gradients needs a MaskedBatch (did you "
                            "mean gradients(), or forget batch_policy=?)")
        grads, aux = _per_chain_grads(len(ctx.batch), lambda c: _oracle_grads(
            grad_fn, chain_at(ctx.x_hat, c), ctx.batch[c], has_aux))
        return ctx._replace(grads=grads, aux=aux)

    return stateless(update)


def batch_scaled_gamma(base_batch: int) -> SamplerTransform:
    """Linear step-size scaling for heterogeneous batches: a commit that
    averaged ``b`` examples advances with ``gamma_k * b / base_batch``
    (float32, as the JAX package rounds it; the injected noise reads
    ``ctx.gamma`` downstream and scales accordingly).  A scale of exactly
    1.0 when ``b == base_batch``."""

    def update(ctx: StepContext) -> StepContext:
        if not all(isinstance(b, MaskedBatch) for b in ctx.batch):
            raise TypeError("batch_scaled_gamma needs a MaskedBatch upstream")
        sizes = np.array([int(b.size) for b in ctx.batch], np.float32)
        scale = sizes / np.float32(base_batch)
        return ctx._replace(gamma=(np.asarray(ctx.gamma, np.float32) * scale)
                            .astype(np.float32))

    return stateless(update)


def langevin_noise(sigma: float, schedule=None, noise_dtype=torch.float32,
                   noise: str = "torch") -> SamplerTransform:
    """Draw the injected noise ``sqrt(2 sigma gamma_k) G_k`` into
    ``ctx.noise``; ``schedule`` optionally overrides ``gamma_k`` for the
    noise scale only; ``noise`` picks the draw (:func:`noise_like`)."""
    if noise not in NOISE:
        raise ValueError(f"noise must be one of {NOISE}, got {noise!r}")

    def update(ctx: StepContext) -> StepContext:
        C = len(ctx.key_noise)
        gammas = [schedule(ctx.step)] * C if schedule is not None else ctx.gamma
        return ctx._replace(noise=stack_chains([
            noise_like(ctx.key_noise[c], chain_at(ctx.params, c),
                       langevin_scale(sigma, gammas[c]), noise_dtype, noise)
            for c in range(C)]))

    return stateless(update)


def apply_sgld_update() -> SamplerTransform:
    """Commit ``X_{k+1} = X_k - gamma_k grad + noise`` (unfused path): one
    elementwise pass a leaf, chain c's gamma broadcast over its row."""

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
    ``langevin_noise() + apply_sgld_update()`` pair on the hot path.  One
    launch a leaf commits every chain under its own key, gamma and
    scale.  Chains in ``ctx.skip`` keep their rows bitwise; with
    ``ctx.check`` the launches report non-finite chains in
    ``ctx.nonfinite`` (``(C,)`` int32, one buffer for every leaf)."""

    def update(ctx: StepContext) -> StepContext:
        if ctx.grads is None:
            raise ValueError("fused_update needs a gradients() stage first")
        flags = None
        if ctx.check:
            flags = torch.zeros(len(ctx.gamma), dtype=torch.int32,
                                device=tree_leaves(ctx.params)[0].device)
        params = fused_langevin_update(
            ctx.params, ctx.grads, [rng.key_bits(k) for k in ctx.key_noise],
            ctx.gamma, [langevin_scale(sigma, g) for g in ctx.gamma], ctx.skip, flags)
        return ctx._replace(params=params, nonfinite=flags)

    return stateless(update)


class SVRGState(NamedTuple):
    """State of :func:`svrg_gradients`: the control-variate anchor
    ``X~`` (a copy of the parameters) and the full gradient at it."""

    anchor: PyTree
    anchor_grad: PyTree


def svrg_gradients(grad_fn: GradFn, full_grad_fn: Callable[[PyTree], PyTree],
                   *, anchor_every: int, has_aux: bool = False
                   ) -> SamplerTransform:
    """SVRG-Langevin gradient oracle: the minibatch gradient with a
    control variate against a periodically refreshed full-data anchor,

    ``g_k = grad_fn(x_hat_k, B_k) - grad_fn(anchor, B_k) + full_grad_fn(anchor)``.

    Every ``anchor_every`` commits (``step % anchor_every == 0``, the first
    commit included) the anchor moves to a **copy** of the current iterate
    — the fused commit updates the parameters in place, and an aliased
    anchor would drift with the chain — and one full gradient is paid
    there.  ``grad_fn`` follows the batch contract (plain, or per-example
    under a :class:`MaskedBatch`); ``aux`` comes from the read-point term.
    """
    if anchor_every < 1:
        raise ValueError(f"anchor_every must be >= 1, got {anchor_every}")

    def init(params):
        # the zero anchor_grad is never read: step 0 re-anchors first
        return SVRGState(anchor=tree_map(torch.clone, params),
                         anchor_grad=tree_zeros_like(params))

    def update(ctx: StepContext, state: SVRGState):
        C = len(ctx.batch)
        if ctx.step % anchor_every == 0:  # one commit counter for every chain
            state = SVRGState(
                anchor=tree_map(torch.clone, ctx.params),
                anchor_grad=stack_chains([full_grad_fn(chain_at(ctx.params, c))
                                          for c in range(C)]))

        def oracle(c):
            grads, aux = _oracle_grads(grad_fn, chain_at(ctx.x_hat, c),
                                       ctx.batch[c], has_aux)
            anchor_grads, _ = _oracle_grads(grad_fn, chain_at(state.anchor, c),
                                            ctx.batch[c], has_aux)
            return tree_map(lambda g, ga, mu: g - ga + mu.to(g.dtype), grads,
                            anchor_grads, chain_at(state.anchor_grad, c)), aux

        grads, aux = _per_chain_grads(C, oracle)
        return ctx._replace(grads=grads, aux=aux), state

    return SamplerTransform(init, update)


def stale_correction(strength: float = 1.0,
                     gamma_scale: float = 0.0) -> SamplerTransform:
    """Stale-gradient compensation for delayed reads (Chen et al.,
    *Stochastic Gradient MCMC with Stale Gradients*), on commits with
    staleness ``tau_k = ctx.delay > 0``:

    - ``g <- g + strength * g * g * (X_k - X_hat_k)`` (first-order Taylor
      toward the fresh read point, diagonal empirical-Fisher Hessian);
    - ``gamma <- gamma / (1 + gamma_scale * tau_k)`` (float32).

    A fresh read (``tau_k = 0``) leaves the chain's gradient and gamma
    untouched, so it commits bitwise as the uncorrected chain.
    """

    def fix(g, x, xh):
        return g + torch.tensor(strength, dtype=g.dtype) * g * g * (x - xh).to(g.dtype)

    def update(ctx: StepContext) -> StepContext:
        if ctx.grads is None:
            raise ValueError("stale_correction needs a gradients() stage first")
        delay = np.asarray(ctx.delay, np.int64)
        stale = np.flatnonzero(delay > 0)
        if stale.size == 0:
            return ctx
        if stale.size == delay.size:
            corrected = tree_map(fix, ctx.grads, ctx.params, ctx.x_hat)
        else:  # only the stale chains' rows
            def rows(g, x, xh):
                out = g.clone()
                for c in stale:
                    out[c] = fix(g[c], x[c], xh[c])
                return out

            corrected = tree_map(rows, ctx.grads, ctx.params, ctx.x_hat)
        gamma = np.asarray(ctx.gamma, np.float32)
        scaled = gamma / (np.float32(1.0) + np.float32(gamma_scale)
                          * delay.astype(np.float32))
        return ctx._replace(grads=corrected,
                            gamma=np.where(delay > 0, scaled, gamma).astype(np.float32))

    return stateless(update)


def sghmc_update(sigma: float, *, friction: float = 1.0, precond: Any = None,
                 noise_dtype=torch.float32, noise: str = "torch") -> SamplerTransform:
    """Commit one SGHMC step (Chen, Fox & Guestrin 2014; a momentum buffer
    in the transform state):

    ``V_{k+1} = (1 - gamma_k a) V_k - gamma_k P grad + sqrt(2 a sigma
    gamma_k) sqrt(P) G_k``;  ``X_{k+1} = X_k + gamma_k V_{k+1}``

    with ``a = friction`` and ``P = precond`` an optional diagonal
    inverse-mass preconditioner: a scalar, or a tree shaped like the
    parameters.  Replaces the ``langevin_noise() + apply_sgld_update()``
    pair; ``noise`` picks the draw (:func:`noise_like`).
    """
    if friction <= 0.0:
        raise ValueError(f"friction must be > 0, got {friction}")
    if noise not in NOISE:
        raise ValueError(f"noise must be one of {NOISE}, got {noise!r}")

    def init(params):
        return tree_zeros_like(params)  # momentum buffer V_0 = 0

    def precond_tree(params):
        """One diagonal factor per leaf: None is the identity, a scalar
        broadcasts, a params-shaped tree is taken leafwise."""
        if precond is None:
            return tree_map(lambda p: torch.tensor(1.0, dtype=p.dtype), params)
        if not isinstance(precond, (list, tuple, dict)) and np.ndim(
                precond.cpu() if torch.is_tensor(precond) else precond) == 0:
            return tree_map(lambda p: torch.tensor(float(precond), dtype=p.dtype),
                            params)
        return tree_map(lambda p, f: torch.as_tensor(f, dtype=p.dtype,
                                                     device=p.device),
                        params, precond)

    def update(ctx: StepContext, momentum):
        if ctx.grads is None:
            raise ValueError("sghmc_update needs a gradients() stage first")
        gamma = np.asarray(ctx.gamma, np.float32)
        noise_tree = stack_chains([
            noise_like(ctx.key_noise[c], chain_at(ctx.params, c),
                       langevin_scale(friction * sigma, gamma[c]), noise_dtype, noise)
            for c in range(len(gamma))])
        decay = (np.float32(1.0) - gamma * np.float32(friction)).astype(np.float32)
        gammas, decays = _chain_scalars(gamma, ctx.params), _chain_scalars(decay, ctx.params)

        def step_v(v, g, n, p):
            return (_rows(decays, v) * v
                    - _rows(gammas, v) * p.to(v.dtype) * g.to(v.dtype)
                    + torch.sqrt(p).to(v.dtype) * n.to(v.dtype))

        momentum = tree_map(step_v, momentum, ctx.grads, noise_tree,
                            precond_tree(ctx.params))
        params = tree_map(lambda x, v: (x + _rows(gammas, x) * v.to(x.dtype))
                          .to(x.dtype), ctx.params, momentum)
        return ctx._replace(params=params, noise=noise_tree), momentum

    return SamplerTransform(init, update)


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
    pushing at the end of the previous step), so after the push slot
    ``head_c`` of chain c holds its pre-commit iterate X_k.  The chains'
    ring leaves are ``(C, depth, *shape)``, one head a chain: the push is
    one copy a leaf while every chain commits, and leaves the chains in
    ``ctx.skip`` (masked commits) unpushed."""

    def init(params):
        return delay_lib.init_ring(params, policy.tau)

    def update(ctx: StepContext, ring):
        ring = delay_lib.push(ring, ctx.params,
                              None if ctx.skip is None else ~np.asarray(ctx.skip, bool))
        return ctx._replace(x_hat=policy.read(ctx, ring)), ring

    return SamplerTransform(init, update)
