"""CLI launcher: train an architecture with delayed-gradient SGLD (port of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
        --mode inconsistent --fused --tau 2 --batch 8 --seq 128

Runs on the card (``--device cuda``, the default; it raises without one)
unless ``--device cpu`` asks for the plain path.  Training goes through
the chunked :class:`~repro_torch.train.engine.Engine`: delays from a
simulated asynchronous run of ``--workers`` virtual workers, clipped to
``--tau``; ``--fused`` commits through the CUDA Langevin kernel and, in
``inconsistent`` (W-Icon) mode, reads through the delay kernels.
``--save PATH`` checkpoints the parameters every ``max(--chunk, 100)``
commits and at the end, in the JAX package's single-model layout (its
``restore_ensemble`` reads the file).

One chain of full-width qwen3-4b holds 8.8 GB of bf16 parameters, and W-Icon
keeps ``tau + 1`` more copies in its ring, one gathered read point and one
gradient: at ``--tau 2`` that is 53 GB before activations, which fits an
80 GB card; the launcher's default ``--tau 4`` (71 GB) does not.  A larger
architecture trains at its published widths with its depth cut by
``--layers`` (phi3.5-moe-42b-a6.6b at 3 layers: 4.16 B parameters).  A
frontend architecture's ``--seq`` counts its stub positions too
(internvl2-1b: 256 of them, so ``--seq 384`` gives 128 text tokens).
"""

from __future__ import annotations

import argparse
from dataclasses import replace

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import ShapeConfig, get_arch, get_reduced
from repro_torch.core import WorkerModel, simulate_async
from repro_torch.core.sgld import SGLDConfig
from repro_torch.data import make_batch
from repro_torch.kernels import rng
from repro_torch.models.transformer import Model, init_params
from repro_torch.train.engine import Engine, checkpoint_hook, log_hook
from repro_torch.train.loop import make_train_step
from repro_torch.utils import resolve_device, tree_leaves
from repro_torch.weights import drop_unit_chain


def build(args):
    """Model, initial state, engine and delays of a parsed command line —
    everything :func:`main` runs, for callers that time or inspect it."""
    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_arch(args.arch)
    if args.layers:
        cfg = replace(cfg, num_layers=args.layers)
    shape = ShapeConfig("cli", seq_len=args.seq, global_batch=args.batch,
                        kind="train")
    model = Model(cfg, device=dev)
    key = rng.PRNGKey(args.seed)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed),
                         device=dev, num_chains=1)
    sgld_cfg = SGLDConfig(mode=args.mode, gamma=args.gamma, sigma=args.sigma,
                          tau=args.tau if args.mode in ("consistent",
                                                        "inconsistent") else 0)
    sampler, _ = make_train_step(model, sgld_cfg, fused=args.fused)
    key, init_key = rng.split(key)
    state = sampler.init(params, init_key)
    delays = None
    if args.mode in ("consistent", "inconsistent"):
        trace = simulate_async(WorkerModel(num_workers=args.workers,
                                           seed=args.seed), args.steps,
                               seed=args.seed)
        delays = np.minimum(trace.delays, args.tau)
    hooks = [log_hook(every=10)]
    if args.save:
        hooks.append(checkpoint_hook(args.save, every=max(args.chunk, 100)))
    engine = Engine(sampler, batch_fn=lambda g: make_batch(cfg, shape, g, "train"),
                    chunk_size=args.chunk, hooks=hooks)
    return cfg, model, state, engine, delays


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-scale smoke variant of the arch")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: the config's)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mode", default="sync",
                    choices=["sync", "consistent", "inconsistent", "pipeline"])
    ap.add_argument("--tau", type=int, default=4)
    ap.add_argument("--workers", type=int, default=8,
                    help="virtual workers for the delay trace")
    ap.add_argument("--gamma", type=float, default=1e-3)
    ap.add_argument("--sigma", type=float, default=1e-5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=10,
                    help="commits per engine chunk (hooks run between chunks)")
    ap.add_argument("--fused", action="store_true",
                    help="commit (and, in W-Icon mode, read) through the CUDA kernels")
    ap.add_argument("--save", default=None,
                    help="checkpoint path (npz, the JAX package's format)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs a card) or cpu (the plain path)")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    cfg, model, state, engine, delays = build(args)
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    print(f"{cfg.name}: {n_params/1e6:.1f}M params, mode={args.mode}"
          f"{' (fused)' if args.fused else ''}, chunk={args.chunk}, "
          f"device={model.device}")
    state, _ = engine.run(state, steps=args.steps, delays=delays, key=args.seed)
    if args.save:
        save_checkpoint(args.save, drop_unit_chain(state.params), step=args.steps)
        print("saved", args.save)
    return state


if __name__ == "__main__":
    main()
