"""Posterior-predictive serving on the PyTorch port: train a chain bank,
checkpoint it, serve credible intervals from the restored bank (the torch
twin of ``examples/serve_quickstart.py``).

    PYTHONPATH=src python examples/torch_serve_quickstart.py [--device cuda]
    PYTHONPATH=src python examples/torch_serve_quickstart.py --device cpu --commits 1000

A 32-chain async-SGLD ensemble samples the paper's polynomial-regression
posterior (each chain replaying its own 8-worker asynchronous schedule),
the bank is exported with ``ClusterEngine.save_ensemble``, restored with
``ServeEngine.from_checkpoint``, and queried: ensemble-averaged
predictions with 90% credible intervals, set beside the closed-form
Gaussian posterior predictive.  :func:`check` holds them to it: every
ensemble mean within :data:`MEAN_STDS` closed-form standard deviations
(plus the 32-chain sampling error of a mean), and every interval's
half-width within a factor :data:`WIDTH_FACTOR` of the closed form's
1.645 standard deviations.  ``--device cuda`` (the default) needs a card.
"""

import argparse
import math
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import samplers
from repro_torch.cluster import ClusterEngine, ServeEngine, ensemble_async
from repro_torch.core import PolyRegression, WorkerModel
from repro_torch.kernels import rng
from repro_torch.models import regression_predict
from repro_torch.utils import resolve_device

CHAINS, WORKERS, COMMITS = 32, 8, 4000
GAMMA, SIGMA, BATCH = 2e-4, 1e-3, 256
QUERIES = 9
MEAN_STDS = 3.0     # the ensemble mean's distance to the closed form, in stds
WIDTH_FACTOR = 2.0  # the interval's half-width against 1.645 stds, either way


def batch_fn(reg: PolyRegression, n: int):
    """Minibatches of the regression's data law: the executor hands
    ``batch_fn`` one PRNG key a (commit, chain), the reference's keys, and
    each gives ``reg.sample_batch(key, n)``, the JAX twin's batch for that
    key (on a card two launches of the draw kernel and a product)."""
    return lambda key: reg.sample_batch(key, n)


def run(device="cuda", commits: int = COMMITS, path=None) -> dict:
    """Train, save, restore and serve.  Returns the served statistics, the
    closed form's mean and std at the queries, and the seconds each stage
    took (the card's stages end in a synchronise)."""
    dev = resolve_device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    reg = PolyRegression.make(rng.PRNGKey(0), nu_std=0.1, device=dev)
    mu, cov, _ = reg.posterior_moments(sigma=SIGMA)

    # -- train: every chain replays its own asynchronous P-worker execution
    schedules = ensemble_async(WorkerModel(num_workers=WORKERS, seed=0),
                               commits, CHAINS, seed=0)
    tau = max(s.max_delay for s in schedules)
    sampler = samplers.sgld("consistent", lambda w, b: reg.grad(w, b),
                            gamma=GAMMA, sigma=SIGMA, tau=tau)
    engine = ClusterEngine(sampler, num_chains=CHAINS, chunk_size=500,
                           batch_fn=batch_fn(reg, BATCH))
    state = engine.init(mu, rng.PRNGKey(1), jitter=0.05)
    t0 = time.perf_counter()
    state, _ = engine.run(state, steps=commits, schedule=schedules, key=2)
    sync()
    train_s = time.perf_counter() - t0

    # -- checkpoint the bank, restore it into a ServeEngine
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(path or tmp) / "bank.npz")
        engine.save_ensemble(state, ckpt)
        serve = ServeEngine.from_checkpoint(ckpt, like=torch.zeros(reg.d),
                                            predict_fn=regression_predict(reg),
                                            quantiles=(0.05, 0.5, 0.95), device=dev)

    # -- serve: predictive mean + 90% credible interval
    zs = np.linspace(-1.0, 1.0, QUERIES).astype(np.float32)
    t0 = time.perf_counter()
    res = serve(zs)
    serve_ms = (time.perf_counter() - t0) * 1e3
    psi = np.concatenate([reg.features(torch.from_numpy(zs)).numpy().astype(np.float64),
                          np.ones((QUERIES, 1))], axis=1)
    cf_mean = psi @ mu.cpu().double().numpy()
    cf_std = np.sqrt(np.einsum("qi,ij,qj->q", psi, cov.cpu().double().numpy(), psi))
    return {"z": zs, "res": res, "cf_mean": cf_mean, "cf_std": cf_std, "tau": tau,
            "chains": serve.num_chains, "commits": commits, "train_s": train_s,
            "serve_ms": serve_ms}


def check(out: dict) -> dict:
    """The served statistics against the closed-form posterior predictive:
    per query, the mean's distance in closed-form stds (allowed
    :data:`MEAN_STDS` plus the mean's own sampling error over the chains)
    and the 90% interval's half-width over 1.645 stds (allowed within a
    factor :data:`WIDTH_FACTOR`).  Returns the worst of each and ``ok``."""
    res, cf_mean, cf_std = out["res"], out["cf_mean"], out["cf_std"]
    dist = np.abs(res.mean - cf_mean) / cf_std
    half = (res.quantiles[-1] - res.quantiles[0]) / 2.0
    ratio = half / (1.645 * cf_std)
    allowed = MEAN_STDS + 3.0 / math.sqrt(out["chains"])
    return {"max_mean_stds": float(dist.max()), "allowed_mean_stds": allowed,
            "width_ratio": [float(ratio.min()), float(ratio.max())],
            "ok": bool(np.isfinite(res.mean).all() and (dist <= allowed).all()
                       and (ratio >= 1 / WIDTH_FACTOR).all()
                       and (ratio <= WIDTH_FACTOR).all())}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default; needs a card) or cpu")
    ap.add_argument("--commits", type=int, default=COMMITS)
    args = ap.parse_args(argv)
    out = run(args.device, args.commits)
    res = out["res"]
    print(f"trained {CHAINS} chains x {out['commits']} commits (P={WORKERS}, realized "
          f"max staleness {out['tau']}) in {out['train_s']:.2f} s; restored a "
          f"{out['chains']}-chain bank")
    print(f"{'z':>6} {'mean':>8} {'90% interval':>20} {'closed-form mean':>17} "
          f"{'+-1.645 std':>12}")
    for i, z in enumerate(out["z"]):
        lo, hi = float(res.quantiles[0, i]), float(res.quantiles[-1, i])
        print(f"{z:6.2f} {float(res.mean[i]):8.3f} "
              f"{'[' + f'{lo:7.3f}, {hi:7.3f}' + ']':>20} "
              f"{out['cf_mean'][i]:17.3f} {1.645 * out['cf_std'][i]:12.3f}")
    verdict = check(out)
    print(f"served {QUERIES} queries in {out['serve_ms']:.2f} ms on {args.device}; "
          f"against the closed form: {verdict}")
    return out, verdict


if __name__ == "__main__":
    main()
