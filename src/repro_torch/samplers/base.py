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
from repro_torch.samplers.transform import (
    SamplerTransform,
    StepContext,
    chain_at,
    one_chain,
)
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

    def step(self, state: SamplerState, batch: Any = None, delay: int = 0,
             keys: tuple | None = None) -> tuple[SamplerState, Any]:
        """Run the chain once; ``delay`` is the realized staleness tau_k.
        The step's noise and coordinate-delay keys are split off the
        carried key, ``key, k_noise, k_delay = split(key, 3)``, as the JAX
        sampler splits them — unless explicit ``keys = (k_noise, k_delay)``
        are given (e.g. per-worker keys from the commit's worker and slot):
        the carried key is then left untouched, so the caller's derivation
        is the only source of randomness.  Returns ``(new_state, aux)``
        with aux from the gradients stage.

        This is :meth:`step_chains` at C = 1: the state's tensors are
        viewed with a leading chain axis of 1."""
        stacked = SamplerState(one_chain(state.params), state.step, [state.key],
                               one_chain(state.inner))
        out, aux = self.step_chains(stacked, [batch], [delay],
                                    None if keys is None else [keys])
        return (SamplerState(chain_at(out.params, 0), out.step, out.key[0],
                             chain_at(out.inner, 0)), chain_at(aux, 0))

    def step_chains(self, state: SamplerState, batches: list, delays,
                    keys: list | None = None) -> tuple[SamplerState, Any]:
        """One commit of C chains stacked on a leading axis (``state.key``
        a list of C keys; see :mod:`repro_torch.samplers.transform`):
        ``batches`` a list of C batches, ``delays`` the C realized
        staleness values.  Chain c's keys are split off its carried key as
        :meth:`step` splits them, or are ``keys[c] = (k_noise, k_delay)``
        with the carried keys untouched.  Returns ``(state, aux)`` with
        aux's tensors stacked over the chains."""
        state, aux, _ = self.commit(state, batches, delays, keys)
        return state, aux

    def commit(self, state: SamplerState, batches: list, delays,
               keys: list | None = None, *, skip=None, check: bool = False):
        """:meth:`step_chains` with the guards of a masked commit:
        ``skip`` (``(C,)`` host bools) marks chains whose commit is
        masked — the ring does not push them and the fused commit leaves
        their rows alone (the other stages still run for them; the caller
        keeps their old values) — and ``check`` asks the fused commit for
        its non-finite flags.  Returns ``(state, aux, nonfinite)``:
        ``nonfinite`` the fused commit's ``(C,)`` int32 flags on the
        parameters' device, or None where no stage set them."""
        if keys is not None:
            carried = list(state.key)
            k_noise, k_delay = [k[0] for k in keys], [k[1] for k in keys]
        else:
            splits = [rng.split(k, 3) for k in state.key]
            carried = [s[0] for s in splits]
            k_noise, k_delay = [s[1] for s in splits], [s[2] for s in splits]
        ctx = StepContext(params=state.params, x_hat=state.params, grads=None,
                          noise=None, aux=None,
                          gamma=np.full(len(carried), self.gamma_at(state.step),
                                        np.float32),
                          key_noise=k_noise, key_delay=k_delay, step=state.step,
                          delay=np.asarray(delays, np.int64), batch=list(batches),
                          skip=skip, check=check)
        ctx, inner = self.transform.update(ctx, state.inner)
        return (SamplerState(ctx.params, state.step + 1, carried, inner), ctx.aux,
                ctx.nonfinite)

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
