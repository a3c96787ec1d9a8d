"""Host-side data pipeline: double-buffered prefetch and the dependent
minibatch stream (port of ``repro.data.pipeline``).

:class:`Prefetcher` makes the next batch on a background thread while the
current step runs; on a card it also copies it there, from pinned host
memory on a side stream, off the training stream's critical path.
:func:`ar1_stream` generates the dependent (non-i.i.d.) minibatch sequence
of the Chau-et-al.-shaped scenario, with its normals drawn by
:func:`~repro_torch.kernels.rng.jax_normal`, so a key gives the JAX
package's stream.  The reference's ``mesh`` / ``batch_axes`` placement
(batches sharded over several cards) is not ported: one card.
"""

from __future__ import annotations

import math
import queue
import threading
from typing import Any, Callable, Iterator

import numpy as np
import torch

from repro_torch.kernels import rng
from repro_torch.utils import resolve_device, tree_leaves, tree_map

PyTree = Any


def ar1_stream(key, *, steps: int, batch: int, d: int, rho: float = 0.9,
               mean: float = 0.0, scale: float = 1.0, device="cuda") -> torch.Tensor:
    """A dependent AR(1) minibatch sequence: each of the ``batch * d``
    example coordinates follows its own stationary AR(1) chain,

        e_{t+1} = mean + rho * (e_t - mean) + scale * sqrt(1 - rho^2) * xi_t,

    with ``e_0`` from the stationary marginal ``N(mean, scale^2)``, so every
    step's marginal is that of an i.i.d. ``N(mean, scale^2)`` stream and
    only the temporal dependence changes.  ``key`` is a ``(k0, k1)`` key:
    ``e_0`` is drawn under ``split(key)[0]`` and the innovations under
    ``split(key)[1]``, as the JAX package draws them in float32.
    Returns ``(steps, batch, d)`` float32 on ``device`` (the card by
    default).
    """
    if not 0.0 <= rho < 1.0:
        raise ValueError(f"rho must be in [0, 1), got {rho}")
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    dev = resolve_device(device)
    k0, k_noise = rng.split(key)
    f32 = lambda v: torch.tensor(np.float32(v), device=dev)  # noqa: E731
    mean_t, rho_t = f32(mean), f32(rho)
    e = mean_t + f32(scale) * rng.jax_normal(k0, (batch, d), dev)
    out = torch.empty((steps, batch, d), dtype=torch.float32, device=dev)
    out[0] = e
    if steps > 1:
        xi = rng.jax_normal(k_noise, (steps - 1, batch, d), dev)
        innov = f32(scale * math.sqrt(1.0 - rho ** 2))
        for t in range(steps - 1):
            # the multiply-adds XLA fuses on the CPU, rounded once (a zero
            # mean folds away first)
            if mean == 0.0:
                e = rng._fma(rho_t, e, innov * xi[t])
            else:
                e = rng._fma(innov, xi[t], rng._fma(rho_t, e - mean_t, mean_t))
            out[t + 1] = e
    return out


class Prefetcher:
    """Wrap a batch-making callable into a prefetching iterator.

    ``batch_fn(key) -> batch`` (a tree of tensors or numpy arrays, made on
    the host); the keys are the reference's sequence: ``key, sub =
    rng.split(key)`` before each batch, ``batch_fn(sub)`` — bit for bit
    ``jax.random.split``, so one key gives the JAX package's keys in order.
    A background thread keeps up to ``depth`` batches ready.

    On a CUDA ``device`` (the default) each batch's host leaves are pinned
    and copied on a side stream, and an event marks the copy's end;
    ``next()`` makes the caller's current stream wait on that event before
    it hands the batch over, and records the batch's tensors on that
    stream (``record_stream``), so the allocator cannot reuse their memory
    while the consumer's work is pending.  Leaves already on the card pass
    through.  On the CPU the batches come back as tensors, unmoved.

    A ``batch_fn`` that raises re-raises from ``next()``; :meth:`close`
    stops the thread and joins it.
    """

    def __init__(self, batch_fn: Callable[[tuple], PyTree], key, *,
                 device="cuda", depth: int = 2):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.batch_fn = batch_fn
        self.key = rng.key_bits(key)
        self.device = resolve_device(device)
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.stop = threading.Event()
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _place(self, batch: PyTree):
        """-> (batch on the device, copy-done event or None)."""
        batch = tree_map(lambda x: x if torch.is_tensor(x) else torch.as_tensor(x),
                         batch)
        if self._stream is None:
            return batch, None
        with torch.cuda.stream(self._stream):
            out = tree_map(lambda x: x if x.device.type == "cuda" else
                           x.pin_memory().to(self.device, non_blocking=True),
                           batch)
            done = torch.cuda.Event()
            done.record(self._stream)
        return out, done

    def _put(self, item) -> None:
        while not self.stop.is_set():
            try:
                self.q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _worker(self):
        key = self.key
        while not self.stop.is_set():
            key, sub = rng.split(key)
            try:
                item = self._place(self.batch_fn(sub))
            except BaseException as e:  # noqa: BLE001 — re-raised by next()
                self._put(e)
                return
            self._put(item)

    def __iter__(self) -> Iterator[PyTree]:
        return self

    def __next__(self) -> PyTree:
        item = self.q.get()
        if isinstance(item, BaseException):
            raise item
        batch, done = item
        if done is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(done)
            for t in tree_leaves(batch):
                t.record_stream(consumer)
        return batch

    def close(self):
        self.stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self.thread.join(timeout=2.0)
