"""The sampler: threads keys, the step counter and the chained
transform state through one commit (port of ``repro.samplers.base``).

Every modelling decision (stale reads, noise, fusion, overlap) lives in the
transform chain.  State lives where the parameters live; the counter, the
key and the ring head are host values.  A commit may update the state's
tensors in place (the fused commit does, as the JAX engines donate the
state), so a caller that still needs the parameters it passed in keeps a
copy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import numpy as np

from repro_torch.kernels import rng
from repro_torch.samplers.transform import SamplerTransform, StepContext
from repro_torch.utils import tree_map

PyTree = Any
Schedule = Callable[[int], np.float32]


class SamplerState(NamedTuple):
    """Iterate, commit counter, key, chain state."""

    params: PyTree
    step: int
    key: tuple               # (k0, k1), a raw JAX PRNGKey's two words
    inner: Any               # tuple of per-transform states (from chain)


@dataclass(frozen=True)
class Sampler:
    """A transform chain + a gamma schedule, driven one commit at a time."""

    transform: SamplerTransform
    gamma: float | Schedule = 1e-2

    def gamma_at(self, step: int) -> np.float32:
        """Step size at commit ``step`` as a float32: the schedule there,
        or the constant ``gamma``."""
        if callable(self.gamma):
            return np.float32(self.gamma(step))
        return np.float32(self.gamma)

    def init(self, params: PyTree, key) -> SamplerState:
        """Fresh state at ``params``: step 0, the chain ``key`` (a
        ``(k0, k1)`` pair, e.g. ``rng.PRNGKey(seed)``), and every
        transform's state in ``inner`` (chain order)."""
        return SamplerState(params=params, step=0, key=rng.key_bits(key),
                            inner=self.transform.init(params))

    def step(self, state: SamplerState, batch: Any = None,
             delay: int = 0) -> tuple[SamplerState, Any]:
        """Run the chain once; ``delay`` is the realized staleness tau_k.
        The step's noise and coordinate-delay keys are split off the
        carried key, ``key, k_noise, k_delay = split(key, 3)``, as the JAX
        sampler splits them.  Returns ``(new_state, aux)`` with aux from
        the gradients stage."""
        key, k_noise, k_delay = rng.split(state.key, 3)
        ctx = StepContext(params=state.params, x_hat=state.params, grads=None,
                          noise=None, aux=None, gamma=self.gamma_at(state.step),
                          key_noise=k_noise, key_delay=k_delay,
                          step=state.step, delay=int(delay), batch=batch)
        ctx, inner = self.transform.update(ctx, state.inner)
        return SamplerState(ctx.params, state.step + 1, key, inner), ctx.aux

    def run(self, state: SamplerState, batches, delays=None, *,
            collect: bool = True):
        """Commit once per entry of ``batches`` — a sequence with one batch
        a commit (a list of keys, when the oracle draws its own minibatch;
        a tensor or array whose rows are the batches) — at the matching
        staleness of ``delays`` (zeros by default).  Returns the final
        state and, when ``collect``, the iterates stacked on axis 0 on the
        parameters' device (else None): the loop form of the JAX sampler's
        scan.

        Each iterate is copied out as it is committed: a commit may update
        the parameters in place (the fused one does), so keeping the
        tensors themselves would give n views of the last iterate."""
        n = len(batches)
        if delays is None:
            delays = [0] * n
        elif hasattr(delays, "tolist"):  # an array or a tensor
            delays = delays.tolist()
        delays = [int(d) for d in delays]
        if len(delays) != n:
            raise ValueError(f"{len(delays)} delays for {n} batches")
        traj = (tree_map(lambda p: p.new_empty((n, *p.shape)), state.params)
                if collect else None)
        for i in range(n):
            state, _ = self.step(state, batches[i], delays[i])
            if collect:
                tree_map(lambda t, p: t[i].copy_(p), traj, state.params)
        return state, traj
