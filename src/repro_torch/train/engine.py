"""The chunked training engine (port of ``repro.train.engine``).

The JAX ``Engine`` jits one ``lax.scan`` per chunk of commits and donates
the sampler state.  The port runs each chunk eagerly, commit by commit
(no ``torch.compile``, no CUDA-graph capture), and updates the state in
place where the sampler does.  What stays the same:

- delays enter as an int tensor (host int32), read once per commit;
- ``num_traces`` counts distinct chunk lengths — what the JAX counter
  counts as traces;
- a delay trace that demands staler reads than the iterate ring holds is
  refused before the run (``validate_staleness``);
- host-side concerns (logging) are hooks that run between chunks, and
  each chunk's aux is brought to the host once, at its end.

    engine = Engine(sampler, batch_fn=..., hooks=[log_hook(every=10)])
    state, metrics = engine.run(state, steps=1000, delays=trace.delays, key=gen)
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.delay import validate_staleness
from repro_torch.core.delay_model import DelayTrace
from repro_torch.obs.metrics import registry as _registry
from repro_torch.obs.trace import span as _span
from repro_torch.samplers.base import Sampler, SamplerState
from repro_torch.utils import tree_leaves, tree_map

PyTree = Any
BatchFn = Callable[[torch.Generator], PyTree]  # generator -> one batch
#: hook(step_end, state, chunk_aux) -> None; chunk_aux is the chunk's aux
#: stacked over its commits (numpy; index [-1] is newest)
Hook = Callable[[int, SamplerState, Any], None]


def log_hook(every: int = 10, log_fn: Callable[[str], None] = print,
             key: str = "loss") -> Hook:
    """Print ``key`` from the newest aux every ``every`` steps
    (chunk-aligned), in the JAX package's format; every line also lands in
    the metrics registry (``train.log_lines``, ``train.last_<key>``)."""
    reg = _registry()
    lines = reg.counter("train.log_lines", "log_hook lines emitted")
    newest = reg.gauge(f"train.last_{key}", "newest logged aux scalar")
    t0 = time.time()
    last = [-every]

    def hook(step_end: int, _state: SamplerState, aux) -> None:
        if aux is None or step_end - last[0] < every:
            return
        if isinstance(aux, dict) and key not in aux:
            return
        last[0] = step_end
        val = aux[key] if isinstance(aux, dict) else aux
        leaf = tree_leaves(val)
        if not leaf:
            return
        scalar = float(np.asarray(leaf[0])[-1])
        lines.inc()
        newest.set(scalar)
        log_fn(f"step {step_end - 1:5d} {key} {scalar:8.4f} "
               f"({time.time() - t0:6.1f}s)")

    return hook


def checkpoint_hook(path: str, every: int = 100) -> Hook:
    """Save ``state.params`` to ``path`` every ``every`` steps
    (chunk-aligned), in the JAX package's single-model layout (a port
    model's chain axis of 1 dropped: :func:`~repro_torch.weights.
    drop_unit_chain`), with the step as the checkpoint step.

    The hook's ``flush``, which the engine calls after the last chunk,
    saves the final state when the cadence skipped it."""
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.weights import drop_unit_chain

    last = [0]

    def save(step_end: int, state: SamplerState) -> None:
        last[0] = step_end
        save_checkpoint(path, drop_unit_chain(state.params), step=step_end)

    def hook(step_end: int, state: SamplerState, _aux) -> None:
        if step_end - last[0] >= every:
            save(step_end, state)

    def flush(step_end: int, state: SamplerState) -> None:
        if step_end > last[0]:
            save(step_end, state)

    hook.flush = flush
    return hook


def _to_host(aux_steps: list) -> PyTree:
    """Per-commit aux trees of 0-d tensors -> one tree of numpy arrays."""
    if not aux_steps or aux_steps[0] is None:
        return None
    return tree_map(lambda *xs: torch.stack([torch.as_tensor(x) for x in xs])
                    .cpu().numpy(), *aux_steps)


def merge_host_aux(aux, host_rows: dict):
    """Thread chunk-aligned host arrays (commit times, cumulative gradient
    evaluations) into a chunk's aux dict (shared by Engine and
    ClusterEngine)."""
    if aux is None:
        return dict(host_rows)
    if isinstance(aux, dict):
        return {**aux, **host_rows}
    return {"aux": aux, **host_rows}


def flush_hooks(hooks: Sequence[Hook], step_end: int, state: SamplerState) -> None:
    """After the final chunk, give every hook with a ``flush`` attribute a
    chance to act on the terminal state."""
    for hook in hooks:
        flush = getattr(hook, "flush", None)
        if flush is not None:
            flush(step_end, state)


def drive_chunks(run_chunk, state: SamplerState, *, steps: int,
                 chunk_size: int, hooks: Sequence[Hook], collect_aux: bool,
                 extra, batches: Optional[PyTree] = None,
                 gen_batches=None, key=None, commit_times=None,
                 host_aux: Optional[dict] = None, chunk_post=None):
    """The host chunk loop shared by :class:`Engine` and
    :class:`~repro_torch.cluster.executor.ClusterEngine`.
    ``run_chunk(state, batches, extra) -> (state, aux)`` runs one chunk;
    ``extra`` is the per-step input (a tensor, or a dict of arrays, with
    leading axis ``steps``: the delays, or the read versions), sliced
    alongside the batches.  Give stacked ``batches`` (leading axis
    ``steps``) or ``gen_batches(key, n) -> (key, chunk_batches)`` plus
    ``key``.  ``commit_times`` and any ``host_aux`` arrays (host, leading
    axis ``steps``) are sliced per chunk into its aux (commit times as
    ``"commit_time"``).  Hooks run between chunks and are flushed at the
    end.  ``chunk_post(done, state) -> state`` (optional) runs after each
    chunk's hooks and may replace the state: the seam where the cluster
    executor respawns chains and writes run checkpoints, so hooks see each
    chunk's raw outcome (quarantines included) before it heals.  Returns
    ``(state, aux stacked over all steps or None)``."""
    if batches is None and gen_batches is None:
        raise ValueError("give stacked `batches` or a batch_fn")
    if batches is not None:
        n_batches = tree_leaves(batches)[0].shape[0]
        if n_batches < steps:
            raise ValueError(f"batches has {n_batches} entries, need {steps}")
    host_rows = dict(host_aux or {})
    if commit_times is not None:
        host_rows["commit_time"] = commit_times
    aux_chunks = []
    done = 0
    while done < steps:
        n = min(chunk_size, steps - done)
        with _span("engine.chunk", start=done, size=n):
            if batches is None:
                key, chunk_batches = gen_batches(key, n)
            else:
                chunk_batches = tree_map(lambda x: x[done:done + n], batches)
            state, aux = run_chunk(state, chunk_batches,
                                   tree_map(lambda x: x[done:done + n], extra))
            done += n
            if host_rows:
                aux = merge_host_aux(aux, {k: np.asarray(v[done - n:done])
                                           for k, v in host_rows.items()})
            if collect_aux:
                aux_chunks.append(aux)
            for hook in hooks:
                hook(done, state, aux)
            if chunk_post is not None:
                state = chunk_post(done, state)
    flush_hooks(hooks, done, state)
    if not aux_chunks or aux_chunks[0] is None:
        return state, None
    return state, tree_map(lambda *xs: np.concatenate(xs, axis=0), *aux_chunks)


@dataclass
class Engine:
    """Chunked SGLD training engine over a composable sampler.

    ``batch_fn(generator) -> batch`` draws one batch; pass ``batches=`` to
    ``run`` instead for pre-made data.  ``chunk_size`` sets how often the
    hooks run and the aux comes to the host.  The sampler's transform state
    (delay rings, pending gradients) rides in ``state.inner``."""

    sampler: Sampler
    batch_fn: Optional[BatchFn] = None
    chunk_size: int = 50
    hooks: Sequence[Hook] = ()
    collect_aux: bool = True
    _lengths: set = field(default_factory=set, init=False, repr=False)

    def __post_init__(self):
        if self.chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {self.chunk_size}")

    @property
    def num_traces(self) -> int:
        """Distinct chunk lengths run so far (the JAX engine's trace count)."""
        return len(self._lengths)

    def _run_chunk(self, state: SamplerState, batches, delays):
        self._lengths.add(len(delays))
        auxs = []
        for j, d in enumerate(delays.tolist()):
            state, aux = self.sampler.step(
                state, tree_map(lambda x: x[j], batches), d)
            if self.collect_aux:
                auxs.append(aux)
        return state, _to_host(auxs)

    def run(self, state: SamplerState, *, steps: int,
            batches: Optional[PyTree] = None, delays=None, key=None):
        """Advance ``steps`` commits.  Returns ``(state, aux)`` with aux the
        per-step aux stacked over all steps (numpy), or ``None``.

        Give stacked ``batches`` (leading axis ``steps``), or a ``batch_fn``
        at construction plus ``key`` here: a ``torch.Generator`` or an int
        seed of one.  ``delays`` may be a
        :class:`~repro_torch.core.delay_model.DelayTrace`, whose commit
        times then land in the aux under ``"commit_time"``.  The state's
        tensors may be updated in place."""
        commit_times = None
        if isinstance(delays, DelayTrace):
            commit_times = delays.commit_times
            delays = delays.delays
        delays = (torch.zeros(steps, dtype=torch.int32) if delays is None
                  else torch.as_tensor(np.asarray(delays), dtype=torch.int32))
        if delays.shape[0] < steps:
            raise ValueError(f"delays has {delays.shape[0]} entries, need {steps}")
        validate_staleness(int(delays[:steps].max()) if steps else 0,
                           state.inner, context="trace")
        gen_batches = None
        if self.batch_fn is not None and batches is None:
            if key is None:
                raise ValueError("generating batches from batch_fn needs `key`")
            if not isinstance(key, torch.Generator):
                key = torch.Generator().manual_seed(int(key))

            def gen_batches(gen, n):
                drawn = [self.batch_fn(gen) for _ in range(n)]
                return gen, tree_map(lambda *xs: torch.stack(
                    [torch.as_tensor(x) for x in xs]), *drawn)

        return drive_chunks(
            self._run_chunk, state, steps=steps, chunk_size=self.chunk_size,
            hooks=self.hooks, collect_aux=self.collect_aux, extra=delays,
            batches=batches, gen_batches=gen_batches, key=key,
            commit_times=commit_times)
