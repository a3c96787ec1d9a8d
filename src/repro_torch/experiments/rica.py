"""Paper §3.3: Reconstruction ICA under async SGLD — the GPU/MPS (M2)
experiment (port of ``repro.experiments.rica``).  Figures 5-8 / 11-12 /
16-17: objective vs iteration, distance to the SGLD optimum, speedup at P
in {2, 4, 8}.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import samplers
from repro_torch.core import (
    RICA,
    WorkerModel,
    simulate_async,
    simulate_sync,
    speedup_vs_sync,
)
from repro_torch.experiments.regression import MODES, _mode_run
from repro_torch.kernels import rng
from repro_torch.utils import resolve_device


@dataclass
class RicaCurve:
    iters: np.ndarray
    objective: np.ndarray
    dist_to_opt: np.ndarray
    times: np.ndarray
    speedup: float = 1.0


def run_rica_experiment(P: int = 4, nu: float = 0.01, steps: int = 800,
                        gamma: float = 2e-3, batch: int = 512,
                        patch_dim: int = 64, num_features: int = 48,
                        tau_cap: int = 8, seed: int = 0,
                        modes=MODES, device="cuda") -> dict[str, RicaCurve]:
    """nu is the injected-noise std (the paper's nu_i): sigma = nu^2 /
    (2 gamma).  Patches, chains and objectives run on ``device``."""
    dev = resolve_device(device)
    rica = RICA(patch_dim=patch_dim, num_features=num_features, device=dev)
    sigma = nu**2 / (2.0 * gamma)
    w0 = rica.init_params(rng.PRNGKey(seed))
    # GPU/MPS-like worker model: low heterogeneity, high update cost
    wm = WorkerModel(num_workers=P, cv=0.15, heterogeneity=0.05,
                     update_cost=0.15, seed=seed)
    tr_sync = simulate_sync(wm, max(steps // P, 1), seed=seed)
    tr_async = simulate_async(wm, steps, seed=seed)

    # reference optimum: plain SGD long run (the paper's "optimal of SGLD")
    def grad(p, key):
        return rica.grad(p, rica.sample_batch(key, batch))

    opt_sampler = samplers.sgld("sync", grad, gamma=gamma, sigma=0.0)
    opt_state = opt_sampler.init(w0, rng.PRNGKey(seed + 9))
    keys_opt = rng.split(rng.PRNGKey(seed + 10), 2 * steps)
    opt_state, _ = opt_sampler.run(opt_state, keys_opt, collect=False)
    w_ref = opt_state.params

    eval_batch = rica.sample_batch(rng.PRNGKey(seed + 11), 1024)

    results = {}
    for mode in modes:
        is_sync = mode == "sync"
        n_commits, delays, times = _mode_run(mode, steps, P, tau_cap,
                                             tr_sync, tr_async)
        eff_batch = batch * P if is_sync else batch

        def grad_m(p, key, _b=eff_batch):
            return rica.grad(p, rica.sample_batch(key, _b))

        sampler = samplers.sgld(mode, grad_m, gamma=gamma, sigma=sigma,
                                tau=tau_cap if not is_sync else 0)
        state = sampler.init(w0, rng.PRNGKey(seed + 1))
        keys = rng.split(rng.PRNGKey(seed + 2), n_commits)
        state, traj = sampler.run(state, keys, delays)

        ev = max(5, n_commits // 30)
        idx = np.arange(0, n_commits, ev)
        objs = torch.stack([rica.value(traj[i], eval_batch) for i in idx])
        dists = torch.stack([torch.sqrt(torch.sum((traj[i] - w_ref) ** 2))
                             for i in idx])
        results[mode] = RicaCurve(
            iters=idx + 1, objective=objs.cpu().numpy(),
            dist_to_opt=dists.cpu().numpy(), times=times[idx],
            speedup=1.0 if is_sync else speedup_vs_sync(tr_async, tr_sync))
    return results
