#!/usr/bin/env python3
"""xlstm-1.3b at its published widths in the JAX package and in the PyTorch
port, from the same weights: how far each package's replay and its forward
part as the depth grows, and how large the gradient at the random init is.

Both packages serve the recurrent stacks by replay (``init_cache``, then
one ``serve_step`` a token).  A random-weight xLSTM stack amplifies any
rounding difference layer after layer, so the replayed logits and one
``forward`` of the same stream part by more with every layer.  Each run
draws one chain with the JAX init and carries it into the port
(``weights.from_jax_params``); batches come from numpy.  Two measurements,
each printed as one JSON line a depth and dtype:

- ``replay``: a 48-token stream through each package's ``serve_step``
  against that package's own forward (the largest relative L2 error of the
  logits over the positions), and the port's forward against the JAX
  package's;
- ``grad``: the loss's gradient on one 2 x 129-token batch in float32, in
  each package: the leaves with the largest |gradient| in each, and the
  largest relative difference of a leaf's largest |gradient| between the
  packages; beside it, the same difference between the JAX package's
  gradient and its gradient at weights moved by one float32 ulp (each
  element up or down at random), which measures how far rounding alone
  carries the gradient at that depth.

xlstm-1.3b's widths (d_model 2048, 4 heads, the 7:1 mLSTM / sLSTM
pattern), with the vocabulary cut to 512 (the embedding is not part of the
recurrence) so that it runs on a CPU.  Run from the repository root (about
5 minutes on 4 CPU threads with the defaults)::

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/torch_recurrent_witness.py \\
        [--depths 2 8 16] [--grad-depths 8]
"""

from __future__ import annotations

import argparse
import json
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_arch as jax_arch
from repro.models.transformer import Model as JaxModel
from repro.models.transformer import init_params as jax_init
from repro.models.transformer import loss_fn as jax_loss_fn
from repro_torch.configs import get_arch
from repro_torch.models.transformer import Model
from repro_torch.train.loop import make_grad_fn
from repro_torch.weights import from_jax_params

T, VOCAB = 48, 512


def _rel(a, b):
    return float((np.linalg.norm(a - b, axis=-1) / np.linalg.norm(b, axis=-1)).max())


def _setup(depth: int, dtype: str):
    jcfg = replace(jax_arch("xlstm-1.3b"), num_layers=depth, dtype=dtype, vocab_size=VOCAB)
    tcfg = replace(get_arch("xlstm-1.3b"), num_layers=depth, dtype=dtype, vocab_size=VOCAB)
    jparams = jax_init(jax.random.PRNGKey(20), jcfg)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return JaxModel(jcfg, remat=False), jparams, Model(tcfg, device="cpu"), tparams


def replay(depth: int, dtype: str) -> dict:
    jm, jparams, tm, tparams = _setup(depth, dtype)
    stream = np.random.default_rng(21).integers(0, VOCAB, (1, T)).astype(np.int32)
    jref, _, _ = jax.jit(lambda p, t: jm.forward(p, {"tokens": t}))(jparams, stream)
    jstep, jcache, jdec = jax.jit(jm.serve_step), jm.init_cache(1, T), []
    for t in range(T):
        logits, jcache = jstep(jparams, jcache, jnp.asarray(stream[:, t:t + 1]), jnp.int32(t))
        jdec.append(np.asarray(logits[:, 0], np.float32))
    with torch.no_grad():
        tref, _, _ = tm.forward(tparams, {"tokens": stream})
        tcache, tdec = tm.init_cache(1, T), []
        for t in range(T):
            logits, tcache = tm.serve_step(tparams, tcache, stream[:, t:t + 1], t)
            tdec.append(logits[0, :, 0].float().numpy())
    return {"what": "replay", "depth": depth, "dtype": dtype,
            "jax_replay_vs_forward": _rel(np.stack(jdec, 1), np.asarray(jref, np.float32)),
            "port_replay_vs_forward": _rel(np.stack(tdec, 1), tref[0].float().numpy()),
            "port_vs_jax_forward": _rel(tref[0].float().numpy(),
                                        np.asarray(jref, np.float32))}


def _largest(tree) -> dict:
    """Each leaf's largest |value|, by its path in the tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(path): float(np.abs(np.asarray(v)).max()) for path, v in flat}


def grad(depth: int) -> dict:
    jm, jparams, tm, tparams = _setup(depth, "float32")
    batch = {"tokens": np.random.default_rng(22).integers(0, VOCAB, (2, 129))
             .astype(np.int32)}
    jg = jax.jit(jax.grad(lambda p, b: jax_loss_fn(jm, p, b)[0]))(
        jparams, {"tokens": jnp.asarray(batch["tokens"])})
    want = _largest(jax.tree_util.tree_map(np.asarray, jg))
    rng = np.random.default_rng(23)
    ulp = jax.tree_util.tree_map(
        lambda a: a * (1 + np.float32(2.0 ** -23) * rng.choice(
            np.array([-1, 1], np.float32), a.shape)), jparams)
    moved = _largest(jax.tree_util.tree_map(np.asarray, jax.jit(
        jax.grad(lambda p, b: jax_loss_fn(jm, p, b)[0]))(
            ulp, {"tokens": jnp.asarray(batch["tokens"])})))
    del jg, jparams, ulp
    tg, _ = make_grad_fn(tm)(tparams, {"tokens": torch.from_numpy(batch["tokens"])})
    got = _largest(jax.tree_util.tree_map(lambda t: t[0].numpy(), tg))
    assert got.keys() == want.keys()
    top = lambda d: [{"leaf": k, "max_abs": d[k]}  # noqa: E731
                     for k in sorted(d, key=d.get, reverse=True)[:4]]
    return {"what": "grad", "depth": depth, "dtype": "float32",
            "tokens": list(batch["tokens"].shape), "jax_largest": top(want),
            "port_largest": top(got),
            "leaf_max_rel_diff": _diff(got, want),
            "jax_ulp_moved_leaf_max_rel_diff": _diff(moved, want)}


def _diff(got: dict, want: dict) -> float:
    return max(abs(got[k] - want[k]) / want[k] for k in want if want[k] > 0)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--depths", type=int, nargs="*", default=[2, 8, 16])
    ap.add_argument("--dtypes", nargs="+", default=["float32", "bfloat16"])
    ap.add_argument("--grad-depths", type=int, nargs="*", default=[8])
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    for depth in args.depths:
        for dtype in args.dtypes:
            print(json.dumps(replay(depth, dtype)), flush=True)
    for depth in args.grad_depths:
        print(json.dumps(grad(depth)), flush=True)


if __name__ == "__main__":
    main()
