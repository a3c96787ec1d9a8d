"""Chain ensembles: the whole sampler transform chain (the iterate
:class:`~repro_torch.core.delay.RingBuffer` included) over C chains stacked
on a leading axis, so one step advances the whole population (port of
``repro.cluster.ensemble``).

The JAX package vmaps ``Sampler.step``; the port's transforms take the
chains stacked (:mod:`repro_torch.samplers.transform`): the read and the
fused commit are one kernel launch a leaf for every chain, the gradient
one oracle call a chain.  Chain ``c`` computes bit for bit what a
single-chain :class:`~repro_torch.samplers.base.Sampler` (the same step at
C = 1) computes with the same key and schedule
(``tests/test_torch_cluster.py``).

The paper's convergence claim is *in measure*: at any commit count the
chain cloud ``(C, d)`` is a sample from the current law, and
:func:`ensemble_w2` measures empirical W2 against target-posterior draws;
:func:`split_rhat` and :func:`ess` are the cross-chain diagnostics.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.kernels import rng
from repro_torch.metrics.wasserstein import sinkhorn_w2, w2_empirical_1d
from repro_torch.obs.metrics import registry as _registry
from repro_torch.samplers.base import Sampler, SamplerState
from repro_torch.samplers.transform import chain_at, map_tensors
from repro_torch.utils import (
    gather_chains,
    tree_broadcast_leading,
    tree_flatten,
    tree_leaves,
    tree_unflatten,
)

PyTree = Any

#: fold_in tag of the jitter key (``repro.cluster.ensemble``)
_JITTER_TAG = 0x6A17
#: fold_in tags separating the worker-attributed noise and coordinate-delay
#: streams (the JAX package's constants)
_WORKER_NOISE_TAG = 0x5747_4E01
_WORKER_DELAY_TAG = 0x5747_4401


def _stack_inits(init: Callable, stacked: PyTree, num_chains: int):
    """Every chain's transform state, stacked on a leading chain axis,
    filled one chain at a time (only one chain's loose state lives at
    once: a ring is ``tau + 1`` parameter copies)."""
    out = None
    for c in range(num_chains):
        s = init(chain_at(stacked, c))
        if out is None:
            out = map_tensors(lambda t: t.new_empty((num_chains, *t.shape)), s)
        map_tensors(lambda o, t, c=c: o[c].copy_(t), out, s)
        del s
    return out


def init_ensemble(sampler: Sampler, params: PyTree, key=None, *,
                  num_chains: int | None = None, keys=None,
                  jitter: float = 0.0, chains: slice | None = None) -> SamplerState:
    """C chains from one start: every tensor of the
    :class:`~repro_torch.samplers.base.SamplerState` gains a leading chain
    axis (the ring's leaves are ``(C, depth, *leaf)``); ``step`` stays one
    int and ``key`` becomes a list of C keys.

    Pass ``key`` + ``num_chains`` (chain ``c``'s key is ``split(key,
    C)[c]``, the spelling single-chain parity checks use) or explicit
    per-chain ``keys``.  ``jitter`` adds iid N(0, jitter^2) to each chain's
    start (float32 leaves): the JAX package's draw under ``fold_in(key,
    0x6A17)`` (``fold_in(keys[0], ...)`` with explicit keys), leaf ``i``
    under its ``i``-th split.

    ``chains`` (a slice of the C chains) builds only that block — the
    rows a rank holds when the chains are placed over a device mesh
    (:func:`repro_torch.utils.chain_block`): chain ``c`` keeps its key and
    its jitter rows, so the blocks, stacked, are the whole state bit for
    bit.
    """
    if keys is None:
        if key is None or num_chains is None:
            raise ValueError("pass either `keys` or (`key`, `num_chains`)")
        keys = rng.split(rng.key_bits(key), num_chains)
        k_jitter = rng.fold_in(rng.key_bits(key), _JITTER_TAG)
    else:
        keys = [rng.key_bits(k) for k in keys]
        k_jitter = rng.fold_in(keys[0], _JITTER_TAG)
    rows = range(len(keys))[chains if chains is not None else slice(None)]
    if rows.step != 1:
        raise ValueError(f"chains must be a contiguous block, got {chains}")
    keys = keys[rows.start:rows.stop]
    C = len(keys)
    stacked = tree_broadcast_leading(params, C)
    if jitter > 0.0:
        leaves, treedef = tree_flatten(stacked)
        out = []
        for k, x in zip(rng.split(k_jitter, len(leaves)), leaves):
            if x.dtype != torch.float32:
                raise ValueError(f"jitter draws float32 starts, got a {x.dtype} leaf")
            # the block's rows of the whole (C, *leaf) draw
            n = rng.jax_normal(k, x.shape, x.device, start=rows.start * x[0].numel())
            out.append(rng._fma(torch.tensor(np.float32(jitter)), n, x))
        stacked = tree_unflatten(treedef, out)
    return SamplerState(params=stacked, step=0, key=keys,
                        inner=_stack_inits(sampler.transform.init, stacked, C))


def worker_keys(chain_key, worker_id: int, slot: int) -> tuple:
    """Per-commit ``(noise, coordinate-delay)`` keys from the chain key and
    the commit's ``(worker_id, worker-local slot)``: ``fold_in(fold_in(
    fold_in(key, tag), worker_id), slot)`` with the JAX package's tags, so
    each worker's noise stream does not depend on the global commit
    order."""
    def derive(tag):
        k = rng.fold_in(rng.fold_in(chain_key, tag), int(worker_id))
        return rng.fold_in(k, int(slot))

    return derive(_WORKER_NOISE_TAG), derive(_WORKER_DELAY_TAG)


def step_chains(sampler: Sampler, state: SamplerState, batches: list, delays,
                worker_ids=None, slots=None) -> tuple[SamplerState, Any]:
    """One commit of every chain (:meth:`Sampler.step_chains`): ``batches``
    a list of C batches, ``delays`` the C realized staleness values.  Keys
    are split off each chain's carried key as :meth:`Sampler.step` splits
    them, or — with ``worker_ids`` and ``slots`` — derived by
    :func:`worker_keys`, the carried keys untouched.  Returns ``(state,
    aux)`` with aux's tensors stacked over the chains."""
    keys = None
    if worker_ids is not None:
        keys = [worker_keys(k, w, s) for k, w, s in zip(state.key, worker_ids, slots)]
    return sampler.step_chains(state, batches, delays, keys)


def ensemble_step(sampler: Sampler, *, batch_axis: Optional[int] = None,
                  worker_rng: bool = False) -> Callable:
    """The population commit ``(state, batch, delay[, worker_id, slot]) ->
    (state, aux)``: ``batch_axis=None`` gives one batch to every chain (the
    parity configuration), ``batch_axis=0`` chain ``c`` the ``[c]`` slice
    of every batch tensor; ``delay`` holds C values.  With ``worker_rng``
    the per-commit keys come from :func:`worker_keys`."""

    def step(state, batch, delay, worker_id=None, slot=None):
        C = len(state.key)
        batches = ([batch] * C if batch_axis is None
                   else [chain_at(batch, c) for c in range(C)])
        if worker_rng:
            if worker_id is None or slot is None:
                raise ValueError("worker_rng needs worker_id and slot")
            return step_chains(sampler, state, batches, delay, worker_id, slot)
        return step_chains(sampler, state, batches, delay)

    return step


def chain_positions(tree: PyTree) -> torch.Tensor:
    """Flatten per-chain params ``(C, ...)`` into the cloud ``(C, d)``
    (float32, leaves in JAX's order).  Placed params are gathered first
    (:func:`~repro_torch.utils.gather_chains`): a hook sees all C
    chains."""
    leaves = tree_leaves(gather_chains(tree))
    c = leaves[0].shape[0]
    return torch.cat([x.reshape(c, -1).float() for x in leaves], dim=1)


def ensemble_w2(positions, target_samples, *, method: str = "auto",
                eps: float = 0.05, num_iters: int = 200) -> torch.Tensor:
    """Empirical W2 between the chain cloud and target-posterior draws:
    the exact 1-D quantile estimator when both clouds are 1-D with equal
    counts (``auto``), else debiased Sinkhorn."""
    positions = torch.as_tensor(positions)
    target = torch.as_tensor(target_samples).to(positions.device)
    positions = positions.reshape(-1, 1) if positions.dim() < 2 else positions
    target = target.reshape(-1, 1) if target.dim() < 2 else target
    if method == "auto":
        one_d = positions.shape[1] == 1 and target.shape[1] == 1
        method = ("1d" if one_d and positions.shape[0] == target.shape[0]
                  else "sinkhorn")
    if method == "1d":
        return w2_empirical_1d(positions[:, 0], target[:, 0])
    if method != "sinkhorn":
        raise ValueError(f"unknown W2 method {method!r}")
    return sinkhorn_w2(positions, target, eps=eps, num_iters=num_iters)


# ---------------------------------------------------------------------------
# cross-chain convergence diagnostics: split-R-hat and ESS over the chain axis
# ---------------------------------------------------------------------------
def split_rhat(draws) -> torch.Tensor:
    """Split-R-hat over the chain axis: ``draws (C, N, d) -> (d,)``.  Each
    chain's N draws are split in half (2C sequences of N//2), then the
    Gelman-Rubin ratio of pooled to within-chain variance."""
    draws = torch.as_tensor(draws)
    C, N, d = draws.shape
    if N < 4:
        raise ValueError(f"split-R-hat needs >= 4 draws per chain, got {N}")
    n = N // 2
    halves = torch.cat([draws[:, :n], draws[:, n:2 * n]], dim=0).float()
    means = halves.mean(dim=1)                                   # (2C, d)
    within = halves.var(dim=1, correction=1).mean(dim=0)
    between = n * means.var(dim=0, correction=1)
    var_plus = (n - 1) / n * within + between / n
    return torch.sqrt(var_plus / torch.clamp_min(within, 1e-30))


def ess(draws) -> torch.Tensor:
    """Bulk effective sample size over the chain axis: ``draws (C, N, d) ->
    (d,)``, the multi-chain (Vehtari/Stan) estimator: per-chain
    autocovariances by FFT (``torch.fft.rfft`` / ``irfft``), combined
    through ``rho_t = 1 - (W - mean acov_t) / var_plus`` with Geyer's
    initial-positive-sequence truncation, capped at ``C N log10(C N)``."""
    draws = torch.as_tensor(draws)
    C, N, d = draws.shape
    if N < 4:
        raise ValueError(f"ESS needs >= 4 draws per chain, got {N}")
    if C < 2:
        raise ValueError("multi-chain ESS needs >= 2 chains")
    x = draws.float()
    means = x.mean(dim=1, keepdim=True)
    xc = x - means
    f = torch.fft.rfft(xc, n=2 * N, dim=1)
    acov = torch.fft.irfft(f * torch.conj(f), n=2 * N, dim=1)[:, :N] / N
    mean_acov = acov.mean(dim=0)                                 # (N, d)
    within = acov[:, 0].mean(dim=0) * N / (N - 1)
    between_over_n = means[:, 0].var(dim=0, correction=1)
    var_plus = (N - 1) / N * within + between_over_n
    rho = 1.0 - (within - mean_acov) / torch.clamp_min(var_plus, 1e-30)
    pairs = rho[0:2 * (N // 2):2] + rho[1:2 * (N // 2):2]        # (N//2, d)
    positive = torch.cumprod((pairs > 0.0).to(pairs.dtype), dim=0)
    tau = -1.0 + 2.0 * torch.sum(pairs * positive, dim=0)
    cap = C * N * max(math.log10(C * N), 1.0)
    return torch.clamp_max(C * N / torch.clamp_min(tau, 1e-6), cap)


def healthy_chains(cloud, state=None) -> np.ndarray:
    """``(C,)`` bool mask of chains fit for ensemble reductions: an
    all-finite ``cloud`` row, and not quarantined when ``state`` carries a
    ``health`` mask."""
    ok = np.isfinite(np.asarray(torch.as_tensor(cloud).cpu())).all(axis=1)
    health = getattr(state, "health", None)
    if health is not None:
        ok &= np.asarray(health)
    return ok


def diagnostics_recorder(*, every: int = 1, window: int = 64) -> Callable:
    """An Engine-style hook recording split-R-hat and ESS of the chain cloud:
    a rolling window of the last ``window`` clouds (one snapshot per
    ``every`` commits, at chunk boundaries); once full, each snapshot adds
    a row ``{"step", "rhat_max", "ess_min", "n_draws"}`` to
    ``hook.record`` (worst coordinate each); ``flush`` adds a final row from
    however much history exists (>= 4 snapshots).  Non-finite chains, and
    chains the state's newest ``health`` mask quarantines, are left out (at
    least 2 must remain)."""
    record: list[dict] = []
    history: list[torch.Tensor] = []
    last = [-every]
    latest_health = [None]  # the newest quarantine mask, when the carry has one

    def note_health(state) -> None:
        health = getattr(state, "health", None)
        if health is not None:
            latest_health[0] = torch.from_numpy(np.asarray(health, bool))

    def measure(step_end: int) -> None:
        if len(history) < 4:
            return
        draws = torch.stack(history, dim=1)  # (C, n, d)
        ok = torch.isfinite(draws).all(dim=2).all(dim=1)
        if latest_health[0] is not None:
            ok &= latest_health[0]
        if not bool(ok.all()):
            if int(ok.sum()) < 2:
                return
            draws = draws[ok]
        row = {"step": step_end,
               "rhat_max": float(split_rhat(draws).max()),
               "ess_min": float(ess(draws).min()),
               "n_draws": int(draws.shape[1])}
        record.append(row)
        reg = _registry()
        reg.gauge("cluster.rhat_max", "worst-coordinate split R-hat of the "
                  "chain cloud").set(row["rhat_max"])
        reg.gauge("cluster.ess_min", "worst-coordinate effective sample "
                  "size").set(row["ess_min"])

    def hook(step_end: int, state: SamplerState, _aux) -> None:
        note_health(state)
        if step_end - last[0] < every:
            return
        last[0] = step_end
        cloud = chain_positions(state.params).cpu()
        if cloud.shape[0] < 2:
            raise ValueError("diagnostics_recorder needs an ensemble of >= 2 "
                             f"chains (got {cloud.shape[0]})")
        history.append(cloud)
        if len(history) > window:
            del history[0]
        if len(history) == window:
            measure(step_end)

    def flush(step_end: int, state: SamplerState) -> None:
        note_health(state)
        if not record or record[-1]["step"] < step_end:
            if step_end > last[0]:
                history.append(chain_positions(state.params).cpu())
                if len(history) > window:
                    del history[0]
            measure(step_end)

    hook.record = record
    hook.flush = flush
    return hook


def w2_recorder(target_samples, *, every: int = 1, **w2_kw) -> Callable:
    """An Engine-style hook measuring the chain cloud's empirical W2 every
    ``every`` commits (chunk-aligned; ``flush`` measures the final state if
    the cadence skipped it).  Rows land in ``hook.record`` as ``{"step",
    "w2", "commit_time", "grad_evals"}``: the ensemble wall clock (max over
    chains) and the mean cumulative gradient evaluations when the executor
    threads them into the aux, else ``None``.  Non-finite chains are left
    out (all of them: ``nan``)."""
    record: list[dict] = []
    last = [-every]
    seen_time = [None]
    seen_evals = [None]

    def measure(step_end: int, state: SamplerState) -> None:
        last[0] = step_end
        cloud = chain_positions(state.params)
        ok = healthy_chains(cloud, state)
        dropped = int(cloud.shape[0] - ok.sum())
        reg = _registry()
        if dropped:
            reg.gauge("chains.unhealthy", "chains currently quarantined or "
                      "non-finite").set(float(dropped))
        if dropped == cloud.shape[0]:
            w2 = float("nan")
        else:
            if dropped:
                cloud = cloud[torch.from_numpy(np.flatnonzero(ok)).to(cloud.device)]
            w2 = float(ensemble_w2(cloud, target_samples, **w2_kw))
        record.append({"step": step_end, "w2": w2, "commit_time": seen_time[0],
                       "grad_evals": seen_evals[0]})
        reg.gauge("cluster.w2", "newest empirical W2 of the chain cloud").set(w2)

    def hook(step_end: int, state: SamplerState, aux) -> None:
        if isinstance(aux, dict) and "commit_time" in aux:
            seen_time[0] = float(np.max(np.asarray(aux["commit_time"])[-1]))
        if isinstance(aux, dict) and "grad_evals" in aux:
            seen_evals[0] = float(np.mean(np.asarray(aux["grad_evals"])[-1]))
        if step_end - last[0] >= every:
            measure(step_end, state)

    def flush(step_end: int, state: SamplerState) -> None:
        if step_end > last[0]:
            measure(step_end, state)

    hook.record = record
    hook.flush = flush
    return hook
