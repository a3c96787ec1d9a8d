"""Posterior-predictive serving from the chain bank (port of
``repro.cluster.serve``).

A converged :class:`~repro_torch.cluster.executor.ClusterEngine` ensemble
is a device-resident cloud of posterior samples.  :class:`ServeEngine`
answers batched predictive queries straight from it: every chain's
forward pass over the query batch, then per-query Bayesian-model-averaged
means, population variances and credible-interval quantiles
(:func:`predictive_stats`), without gathering the bank to the host.

Request batching is shape-bucketed: query counts are padded up a bucket
ladder (powers of two by default) by edge-replicating the last query —
host queries into one reused scratch buffer a rung (``HostScratch.pad``),
so a steady stream allocates nothing on the padding path.  ``submit()`` /
``drain()`` take single queries and group compatible ones into one batch;
``serve()`` is a shim over them.

Differences from the JAX package, by design:

- the predict fn is **bank-form** (:data:`~repro_torch.models.predictive.
  PredictFn`): it takes the whole bank and returns ``(C, Q, ...)``; the
  JAX engine ``vmap``-s a one-chain forward;
- ``mesh`` / ``chain_axis`` place the bank's chains over a
  ``DeviceMesh`` (each rank runs its block's forward; the per-chain
  predictions ``(C, Q, ...)`` are all-gathered over the chain axis, then
  every rank reduces them identically), as the JAX engine's
  ``shard_map``; the bank is never gathered;
- no ``donate``: nothing is jitted, so no buffer is donated, and the
  caller's buffer is never written;
- ``num_traces`` counts the shape rungs met (bucket x query structure):
  nothing is traced, and a rung's first sight is what the JAX engine's
  trace counter counts.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.cluster.api import (
    FINISH_QUERY,
    BankEngine,
    Completion,
    HostScratch,
    Request,
)
from repro_torch.models.predictive import PredictFn
from repro_torch.obs.metrics import LATENCY_MS_BUCKETS, registry as _registry
from repro_torch.obs.trace import now as _now, span as _span
from repro_torch.utils import (
    bucket_size,
    resolve_device,
    to_device,
    tree_flatten,
    tree_leaves,
    tree_unflatten,
)

__all__ = ["PredictFn", "ServeEngine", "ServeResult", "bucket_size",
           "predictive_stats"]

PyTree = Any
#: torch.quantile takes at most 2**24 elements at once
_QUANTILE_MAX = 1 << 24


class ServeResult(NamedTuple):
    """Per-query predictive statistics over the chain axis.

    ``mean`` / ``var`` are ``(Q, ...)`` (the ensemble average and the
    population variance of the per-chain predictions); ``quantiles`` is
    ``(len(qs), Q, ...)`` in the order the engine's ``quantiles`` were
    given — ``quantiles[0]`` / ``[-1]`` bracket the credible interval for
    the default ``(0.05, 0.5, 0.95)``.
    """

    mean: Any
    var: Any
    quantiles: Any

    @property
    def std(self):
        """Posterior-predictive standard deviation, ``sqrt(var)`` in
        whichever array type ``var`` is (numpy or torch)."""
        if isinstance(self.var, np.ndarray):
            return np.sqrt(self.var)
        return torch.sqrt(self.var)


def predictive_stats(preds: torch.Tensor, qs: torch.Tensor) -> ServeResult:
    """Reduce per-chain predictions ``(C, Q, ...)`` to per-query statistics:
    the mean, the population variance, and ``torch.quantile`` at ``qs``
    with its default linear interpolation (``jnp.quantile``'s).  Every
    column is reduced on its own, so a block above ``torch.quantile``'s
    2**24 elements is taken in column chunks with the same result."""
    mean = preds.mean(dim=0)
    var = (preds - mean).square().mean(dim=0)
    qs = qs.to(device=preds.device, dtype=preds.dtype)
    C = preds.shape[0]
    flat = preds.reshape(C, -1)
    step = max(1, _QUANTILE_MAX // C)
    quantiles = torch.cat([torch.quantile(flat[:, i:i + step], qs, dim=0)
                           for i in range(0, flat.shape[1], step)], dim=1)
    quantiles = quantiles.reshape(qs.shape[0], *preds.shape[1:])
    return ServeResult(mean=mean, var=var, quantiles=quantiles)


def _host(x) -> np.ndarray:
    """A query leaf as a host array (a tensor is copied off its device)."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _pad_queries(queries: PyTree, n: int, *, scratch: HostScratch,
                 device) -> PyTree:
    """Pad every leaf's leading (query) axis to ``n`` by edge-replicating
    the last query, as tensors on ``device``.

    A host leaf (numpy, or a tensor elsewhere) is padded into the engine's
    per-rung ``scratch`` (``HostScratch.pad``), then copied to the device;
    a tensor already on ``device`` is padded there with ``torch.cat``, and
    one already ``n`` long is passed through.  The caller's buffer is
    never written."""
    leaves, treedef = tree_flatten(queries)
    out = []
    for i, x in enumerate(leaves):
        if torch.is_tensor(x) and x.device == device:
            extra = n - x.shape[0]
            out.append(x if extra == 0 else torch.cat(
                [x, x[-1:].expand(extra, *x.shape[1:])], dim=0))
        else:
            out.append(to_device(scratch.pad(_host(x), n, key=i), device))
    return tree_unflatten(treedef, out)


@dataclass
class ServeEngine(BankEngine):
    """Batched posterior-predictive serving over a chain-stacked bank.

    ``predict_fn(params, queries) -> preds`` is the bank-form forward
    (``(C, ...)`` params, a leading query axis ``Q`` in, ``(C, Q, ...)``
    out; the builders of :mod:`repro_torch.models.predictive` make one);
    ``params`` the bank on ``device`` (default ``"cuda"``, which needs a
    card) — a :class:`ClusterEngine` state's params, or what
    ``restore_ensemble`` gives.  ``quantiles`` are the levels every answer
    carries; ``buckets`` the query-count ladder (powers of two when None);
    ``mesh`` / ``chain_axis`` place the bank.
    """

    predict_fn: PredictFn
    params: PyTree
    quantiles: Sequence[float] = (0.05, 0.5, 0.95)
    buckets: Optional[Sequence[int]] = None
    device: Any = "cuda"
    mesh: Any = None
    chain_axis: str = "data"

    _FRONT_FIELD = "predict_fn"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._init_bank()
        self._shard_bank()
        self._qs = torch.tensor(self.quantiles, dtype=torch.float32,
                                device=self.device)
        reg = _registry()
        self._m_requests = reg.counter("serve.requests", "serve() calls")
        self._m_queries = reg.counter("serve.queries",
                                      "queries answered (pre-padding)")
        self._m_latency = reg.histogram(
            "serve.request_ms", LATENCY_MS_BUCKETS,
            "serve() wall time per request, result on host")
        self._m_util = reg.gauge(
            "serve.bucket_utilization",
            "last request's Q / padded bucket size")

    # -- streaming ------------------------------------------------------------
    def decoder(self, model, **kw):
        """A :class:`~repro_torch.cluster.decode.DecodeEngine` over the
        *same* bank, bucket ladder, device and mesh: single-shot predictive
        queries and multi-token BMA generation from one restored bank.
        ``model`` is the Model or config the bank parameterizes; extra
        ``kw`` (``max_seq``, ``return_logits``, ...) pass through."""
        from repro_torch.cluster.decode import DecodeEngine

        kw.setdefault("buckets", self.buckets)
        kw.setdefault("device", self.device)
        kw.setdefault("mesh", self.mesh)
        kw.setdefault("chain_axis", self.chain_axis)
        return DecodeEngine(model=model, params=self.params, **kw)

    # -- request-level endpoint -----------------------------------------------
    def _validate_request(self, request: Request) -> None:
        if request.max_new_tokens:
            raise ValueError(
                "ServeEngine answers single-shot predictive queries; a "
                f"Request with max_new_tokens={request.max_new_tokens} "
                "belongs on a decode engine")

    def _drain(self, requests):
        """Group pending single-query requests by structure (tree layout +
        per-leaf trailing shape and dtype), stack each group into one
        batched :meth:`_serve_batch` call in first-submission order, and
        hand every request its row of the statistics as a
        :class:`~repro_torch.cluster.api.Completion` (in ``stats``)."""
        groups: dict = {}
        for r in requests:
            leaves, treedef = tree_flatten(r.tokens)
            arrs = [_host(x) for x in leaves]
            sig = (repr(treedef), tuple((a.shape, a.dtype.str) for a in arrs))
            groups.setdefault(sig, (treedef, []))[1].append((r, arrs))
        out = {}
        for treedef, rows in groups.values():  # dicts keep insertion order
            stacked = [np.stack([arrs[i] for _, arrs in rows])
                       for i in range(len(rows[0][1]))]
            res = self._serve_batch(tree_unflatten(treedef, stacked))
            t_done = _now()
            for i, (r, _) in enumerate(rows):
                r.timing["finished"] = t_done
                out[r.request_id] = Completion(
                    request_id=r.request_id,
                    tokens=np.zeros((0,), np.int32), logits=None,
                    finish_reason=FINISH_QUERY, timing=r.timing,
                    stats=ServeResult(mean=res.mean[i], var=res.var[i],
                                      quantiles=res.quantiles[:, i]))
        return [out[r.request_id] for r in requests]

    # -- serving --------------------------------------------------------------
    @torch.no_grad()
    def _serve_batch(self, queries: PyTree) -> ServeResult:
        """The batch-level program: pad one query batch to its bucket, run
        every chain's forward and the reduction on the device, trim on
        the host."""
        leaves = tree_leaves(queries)
        q = int(leaves[0].shape[0])
        n = bucket_size(q, self.buckets)
        self._see_rung("stats", (n, tuple((tuple(x.shape[1:]), str(x.dtype))
                                          for x in leaves)))
        t0 = _now()
        with _span("serve.request", Q=q, bucket=n, chains=self.num_chains):
            padded = _pad_queries(queries, n, scratch=self._scratch,
                                  device=self.device)
            preds = self.predict_fn(self._bank, padded)
            if tuple(preds.shape[:2]) != (self._local_chains, n):
                raise ValueError(
                    f"predict_fn returned {tuple(preds.shape)}; a bank-form "
                    f"predict fn returns (chains={self._local_chains}, "
                    f"queries={n}, ...)")
            res = predictive_stats(self._all_chains(preds), self._qs)
            mean, var, quantiles = (x.cpu().numpy() for x in res)
        self._m_requests.inc()
        self._m_queries.inc(q)
        self._m_latency.observe((_now() - t0) * 1e3)
        self._m_util.set(q / n)
        return ServeResult(mean=mean[:q], var=var[:q],
                           quantiles=quantiles[:, :q])

    def serve(self, queries: PyTree) -> ServeResult:
        """Answer one batched predictive request.

        ``queries`` leaves share a leading query axis ``Q`` (numpy arrays
        or tensors); the batch is split into per-query requests, submitted
        and drained, and the drain stacks them straight back into one
        bucketed batch.  Returns a :class:`ServeResult` of host (numpy)
        per-query statistics."""
        leaves, treedef = tree_flatten(queries)
        arrs = [_host(x) for x in leaves]
        q = int(arrs[0].shape[0])
        ids = [self.submit(Request(tokens=tree_unflatten(
            treedef, [a[i] for a in arrs]))) for i in range(q)]
        by_id = {c.request_id: c for c in self.drain()}
        rows = [by_id[i].stats for i in ids]
        return ServeResult(
            mean=np.stack([r.mean for r in rows]),
            var=np.stack([r.var for r in rows]),
            quantiles=np.stack([r.quantiles for r in rows], axis=1))

    __call__ = serve
