"""The multi-chain cluster on the PyTorch port: a 32-chain async-SGLD
ensemble (the torch twin of ``examples/cluster_quickstart.py``).

    PYTHONPATH=src python examples/torch_cluster_quickstart.py [--device cuda]
    PYTHONPATH=src python examples/torch_cluster_quickstart.py --sampler svrg --device cpu

Each chain replays its own 8-worker asynchronous execution (an executable
``WorkerSchedule`` compiled from the event-driven simulator); every commit
advances all 32 chains through the sampler's transform chain, ring buffers
included.  The chain cloud is compared with the closed-form Gibbs
posterior by empirical W2 — convergence *in measure*, on the commit and
the simulated wall-clock axis.

The second half turns on the heterogeneous batch policy: the worker pool
re-simulated with ``batch_policy="inverse-speed"``, so slow workers
amortise their staleness over large (bucket-snapped) minibatches, and the
executor takes masked bucket-padded windows of a data stream.

``--sampler`` swaps the ensemble's chain for a zoo variant: ``svrg`` (the
exact full gradient as the control-variate anchor) or ``sghmc`` (a
momentum buffer per chain).  ``run_ensemble(..., fused=True)`` runs
``sgld`` as W-Icon through the fused preset (on a card: one
Langevin-update and one W-Icon-read launch a commit for all 32 chains;
``chip_smoke.py`` phase 8b calls it so).  ``--noise jax`` draws the
unfused noise as ``jax.random.normal`` does, so the W2 rows can be set
beside the JAX example's.  ``--device cuda`` (the default) needs a card.
"""

import argparse
import time

import torch

from repro_torch import samplers
from repro_torch.cluster import ClusterEngine, ensemble_async, w2_recorder
from repro_torch.core import Quadratic, WorkerModel
from repro_torch.kernels import rng
from repro_torch.utils import resolve_device

CHAINS, WORKERS, COMMITS = 32, 8, 600
GAMMA, SIGMA, BASE_BATCH = 0.05, 0.5, 8


def problem(device):
    """The d=2 quadratic and 256 draws of its Gibbs posterior."""
    quad = Quadratic.make(rng.PRNGKey(0), d=2, m=1.0, L=3.0, device=device)
    target = quad.x_star + torch.sqrt(quad.stationary_cov(SIGMA)) * rng.jax_normal(
        rng.PRNGKey(1), (256, quad.d), quad.x_star.device)
    return quad, target


def build_ensemble(sampler_name: str = "sgld", *, device="cuda", fused: bool = False,
                   noise: str = "torch"):
    """The first half's engine (a W2 recorder every 50 commits), initial
    state, per-chain schedules and realized max staleness."""
    dev = resolve_device(device)
    quad, target = problem(dev)
    schedules = ensemble_async(WorkerModel(num_workers=WORKERS, seed=0),
                               COMMITS, CHAINS, seed=0)
    tau = max(s.max_delay for s in schedules)
    grad_fn = lambda p, b: quad.grad(p, b)  # noqa: E731
    if sampler_name == "svrg":
        sampler = samplers.svrg("consistent", grad_fn, lambda p: quad.grad(p, None),
                                anchor_every=64, gamma=GAMMA, sigma=SIGMA, tau=tau,
                                noise=noise)
    elif sampler_name == "sghmc":
        sampler = samplers.sghmc("consistent", grad_fn, gamma=GAMMA, sigma=SIGMA,
                                 friction=2.0, tau=tau, noise=noise)
    elif fused:
        sampler = samplers.sgld("inconsistent", grad_fn, gamma=GAMMA, sigma=SIGMA,
                                tau=tau, fused=True)
    else:
        sampler = samplers.sgld("consistent", grad_fn, gamma=GAMMA, sigma=SIGMA,
                                tau=tau, noise=noise)
    engine = ClusterEngine(sampler, num_chains=CHAINS, chunk_size=50,
                           hooks=[w2_recorder(target, every=50)])
    state = engine.init(torch.zeros(quad.d, device=dev), rng.PRNGKey(2), jitter=2.0)
    return engine, state, schedules, tau


def run_ensemble(sampler_name: str = "sgld", *, device="cuda", fused: bool = False,
                 noise: str = "torch"):
    """The first half: 32 chains, 600 commits.  Returns (W2 rows, engine,
    final state, wall seconds, realized max staleness)."""
    engine, state, schedules, tau = build_ensemble(sampler_name, device=device,
                                                   fused=fused, noise=noise)
    dev = resolve_device(device)
    t0 = time.perf_counter()
    state, _ = engine.run(state, steps=COMMITS, schedule=schedules)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return engine.hooks[0].record, engine, state, time.perf_counter() - t0, tau


def run_heterogeneous(*, device="cuda", noise: str = "torch"):
    """The second half: inverse-speed batches of a 8192 x 2 data stream,
    base batch 8, gamma 0.02.  Returns (w2 rows, engine, state, wall s)."""
    dev = resolve_device(device)
    quad, target = problem(dev)
    wm = WorkerModel(num_workers=WORKERS, heterogeneity=0.6, update_cost=0.6, seed=0)
    scheds = ensemble_async(wm, COMMITS, CHAINS, seed=0,
                            batch_policy="inverse-speed", base_batch=BASE_BATCH)
    tau = max(s.max_delay for s in scheds)
    # a per-example oracle (quadratic drift + per-example gradient noise):
    # analytic, so torch.func.vmap batches it over the padded window
    per_example = lambda p, e: quad.grad(p, None) + e  # noqa: E731
    sampler = samplers.sgld("consistent", per_example, gamma=0.02, sigma=SIGMA,
                            tau=tau, base_batch=BASE_BATCH, noise=noise)
    data = rng.jax_normal(rng.PRNGKey(3), (8192, quad.d), dev)
    w2 = w2_recorder(target, every=50)
    engine = ClusterEngine(sampler, num_chains=CHAINS, chunk_size=50,
                           batch_policy="inverse-speed", hooks=[w2])
    state = engine.init(torch.zeros(quad.d, device=dev), rng.PRNGKey(2), jitter=2.0)
    t0 = time.perf_counter()
    state, _ = engine.run(state, steps=COMMITS, schedule=scheds, data=data)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return w2.record, engine, state, time.perf_counter() - t0, wm


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sampler", choices=("sgld", "svrg", "sghmc"), default="sgld",
                    help="zoo preset for the chain ensemble")
    ap.add_argument("--noise", choices=("torch", "jax"), default="torch",
                    help="the unfused noise draw")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs a card) or cpu")
    args = ap.parse_args()

    rows, engine, _, wall, tau = run_ensemble(args.sampler, device=args.device,
                                              noise=args.noise)
    print(f"{CHAINS} chains x {WORKERS} workers, realized max staleness {tau}")
    print(f"sampler: {args.sampler}")
    print(f"{'commit':>7} {'sim wall clock':>14} {'empirical W2':>12}")
    for row in rows:
        print(f"{row['step']:7d} {row['commit_time']:14.1f} {row['w2']:12.4f}")
    print(f"chunk layouts: {engine.num_traces}; {COMMITS} commits in {wall:.2f} s "
          f"({COMMITS / wall:.1f} commits/s) on {args.device}")

    rows, engine, _, wall, wm = run_heterogeneous(device=args.device, noise=args.noise)
    print(f"\nper-worker batch sizes (inverse-speed, base {BASE_BATCH}): "
          f"{wm.batch_sizes('inverse-speed', base_batch=BASE_BATCH).tolist()}")
    print(f"{'commit':>7} {'grad evals':>11} {'sim wall clock':>14} "
          f"{'empirical W2':>12}")
    for row in rows:
        print(f"{row['step']:7d} {row['grad_evals']:11.0f} "
              f"{row['commit_time']:14.1f} {row['w2']:12.4f}")
    print(f"chunk layouts: {engine.num_traces} (one per bucket-ladder rung per "
          f"chunk length); {COMMITS} commits in {wall:.2f} s")


if __name__ == "__main__":
    main()
