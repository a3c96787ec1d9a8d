"""Quickstart on the PyTorch port: async-SGLD (the paper's algorithm) on a
tiny decoder LM (the torch twin of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cuda]
    PYTHONPATH=src python examples/torch_quickstart.py --sampler sghmc --device cpu

Trains a reduced qwen3-style model for 30 steps with the W-Con (consistent
stale read) sampler — built from the composable ``repro_torch.samplers``
API and driven by the chunked Engine — using delays from the
virtual-worker simulator, then decodes a few tokens through the KV cache.
``--sampler`` swaps in the zoo variants: ``svrg`` (variance-reduced
oracle anchored on a fixed reference batch) or ``sghmc`` (underdamped
momentum chain) — same Engine, same schedule, same delays.  ``--device
cuda`` (the default) needs a card.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import samplers
from repro_torch.configs import ShapeConfig, get_reduced
from repro_torch.core import WorkerModel, simulate_async
from repro_torch.data import make_batch
from repro_torch.kernels import rng
from repro_torch.models.transformer import Model, init_params
from repro_torch.train.engine import Engine, log_hook
from repro_torch.train.loop import make_grad_fn
from repro_torch.utils import resolve_device, tree_leaves

ARCH = "qwen3-4b"
STEPS = 30


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--sampler", choices=("sgld", "svrg", "sghmc"), default="sgld",
                    help="which zoo preset drives the chain")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs a card) or cpu")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    dev = resolve_device(args.device)

    cfg = get_reduced(ARCH)
    shape = ShapeConfig("quickstart", seq_len=128, global_batch=8, kind="train")
    model = Model(cfg, device=dev)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
                         num_chains=1)
    n = sum(t.numel() for t in tree_leaves(params))
    print(f"{cfg.name}: {n / 1e6:.1f}M params on {dev}")

    # The paper's W-Con sampler: stale whole-vector reads with delays from
    # the event-driven virtual-worker model (8 asynchronous workers).  The
    # zoo variants swap the gradient stage (svrg) or the commit stage
    # (sghmc) and nothing else.
    grad_fn = make_grad_fn(model)
    if args.sampler == "svrg":
        # the control variate's anchor: one pinned reference batch stands in
        # for "the full data" of the synthetic token stream
        anchor = make_batch(cfg, shape, torch.Generator().manual_seed(42), "train")
        sampler = samplers.svrg("consistent", grad_fn, lambda p: grad_fn(p, anchor)[0],
                                anchor_every=10, gamma=5e-4, sigma=1e-7, tau=4,
                                has_aux=True)
    elif args.sampler == "sghmc":
        sampler = samplers.sghmc("consistent", grad_fn, gamma=5e-4, sigma=1e-7,
                                 friction=2.0, tau=4, has_aux=True)
    else:
        sampler = samplers.sgld("consistent", grad_fn, gamma=5e-4, sigma=1e-7, tau=4,
                                has_aux=True)
    print(f"sampler: {args.sampler}")
    trace = simulate_async(WorkerModel(num_workers=8, seed=0), STEPS, seed=0)
    delays = np.minimum(trace.delays, 4)
    print(f"simulated delays: mean {trace.mean_delay:.1f}, max {trace.max_delay}")

    key, init_key = rng.split(rng.PRNGKey(0))
    state = sampler.init(params, init_key)
    engine = Engine(sampler, batch_fn=lambda g: make_batch(cfg, shape, g, "train"),
                    chunk_size=5, hooks=[log_hook(every=5)])
    t0 = time.perf_counter()
    state, metrics = engine.run(state, steps=STEPS, delays=delays, key=rng.seed_int(key))
    train_s = time.perf_counter() - t0
    print(f"final loss {float(metrics['loss'][-1]):.4f}; {STEPS} commits in "
          f"{train_s:.2f} s ({STEPS / train_s:.1f} commits/s)")

    # decode a few tokens greedily from the sampled posterior weights
    tokens = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    cache = model.init_cache(1, 32)
    out = []
    with torch.no_grad():
        for t in range(8):
            logits, cache = model.serve_step(state.params, cache, tokens, t)
            tokens = torch.argmax(logits[0, :, -1:], dim=-1).to(torch.int32)
            out.append(int(tokens[0, 0]))
    print("greedy sample:", out)
    print(f"wall {time.perf_counter() - t_start:.2f} s")
    return metrics, out


if __name__ == "__main__":
    main()
