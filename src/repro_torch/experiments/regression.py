"""Paper §3.2: polynomial-regression posterior sampling, Sync vs W-Con vs
W-Icon, with the event-driven delay/wall-clock model standing in for the
paper's NUMA box (port of ``repro.experiments.regression``).  Produces the
data behind Figures 1-4 / 9-15.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import samplers
from repro_torch.core import (
    PolyRegression,
    WorkerModel,
    simulate_async,
    simulate_sync,
    speedup_vs_sync,
)
from repro_torch.kernels import rng
from repro_torch.metrics import w2_to_gaussian
from repro_torch.utils import resolve_device

MODES = ("sync", "consistent", "inconsistent")  # paper: Sync, W-Con, W-Icon


@dataclass
class Curve:
    iters: np.ndarray
    w2: np.ndarray
    times: np.ndarray
    traj2d: np.ndarray      # first two coordinates of the trajectory
    speedup: float = 1.0


def _w2_curve(traj: torch.Tensor, mu, cov, eval_every=100, window=400):
    idx, out = [], []
    for k in range(window, traj.shape[0], eval_every):
        out.append(float(w2_to_gaussian(traj[k - window:k], mu, cov)))
        idx.append(k)
    return np.asarray(idx), np.asarray(out)


def _mode_run(mode: str, steps: int, P: int, tau_cap: int, tr_sync, tr_async):
    """Commits, delays and simulated commit times of one mode: Sync
    consumes P gradients a commit, so it makes ``steps // P`` commits at
    the barrier model's times; W-Con and W-Icon make ``steps`` at the
    free-running model's, with delays capped at ``tau_cap``."""
    if mode == "sync":
        n = max(steps // P, 1)
        return n, np.zeros((n,), np.int32), tr_sync.commit_times[:n]
    return (steps, np.minimum(tr_async.delays[:steps], tau_cap),
            tr_async.commit_times[:steps])


def run_regression_experiment(P: int = 18, nu: float = 0.1,
                              steps: int = 6000, gamma: float = 2e-4,
                              sigma: float = 1e-3, batch: int = 256,
                              tau_cap: int = 16, seed: int = 0,
                              modes=MODES, device="cuda") -> dict[str, Curve]:
    """Returns one Curve per update scheme.

    Sync consumes P gradients per commit (the paper's summed update) so at
    equal gradient-evaluation budget it performs steps//P commits; its wall
    clock comes from the barrier model, async from the free-running model.
    The chains, minibatches and W2 run on ``device``.
    """
    dev = resolve_device(device)
    reg = PolyRegression.make(rng.PRNGKey(seed), nu_std=nu, device=dev)
    mu, cov, _ = reg.posterior_moments(sigma=sigma)
    wm = WorkerModel(num_workers=P, seed=seed)
    results: dict[str, Curve] = {}

    tr_sync = simulate_sync(wm, max(steps // P, 1), seed=seed)
    tr_async = simulate_async(wm, steps, seed=seed)

    for mode in modes:
        is_sync = mode == "sync"
        n_commits, delays, times = _mode_run(mode, steps, P, tau_cap,
                                             tr_sync, tr_async)
        eff_batch = batch * P if is_sync else batch

        def grad(p, key, _b=eff_batch):
            return reg.grad(p, reg.sample_batch(key, _b))

        sampler = samplers.sgld(mode, grad, gamma=gamma, sigma=sigma,
                                tau=tau_cap if not is_sync else 0)
        state = sampler.init(mu + 1.0, rng.PRNGKey(seed + 1))
        keys = rng.split(rng.PRNGKey(seed + 2), n_commits)
        state, traj = sampler.run(state, keys, delays)
        ev = max(10, n_commits // 40)
        win = max(50, min(400, n_commits // 4))
        idx, w2 = _w2_curve(traj, mu, cov, eval_every=ev, window=win)
        results[mode] = Curve(iters=idx, w2=w2, times=times[idx - 1],
                              traj2d=traj[:, :2].cpu().numpy())

    # relative speedup at equal gradient evaluations (paper subfigure b)
    sp = speedup_vs_sync(tr_async, tr_sync)
    for mode in modes:
        results[mode].speedup = 1.0 if mode == "sync" else sp
    return results


def posterior_for(nu: float, sigma: float, seed: int = 0, *, device="cuda"):
    reg = PolyRegression.make(rng.PRNGKey(seed), nu_std=nu, device=device)
    mu, cov, _ = reg.posterior_moments(sigma=sigma)
    return reg, mu, cov
