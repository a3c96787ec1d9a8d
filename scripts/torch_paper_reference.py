#!/usr/bin/env python3
"""Reference values of the paper's two experiments, and the band the
PyTorch port's values must fall in, written to
``tests/fixtures/torch_paper_reference.json``.

Runs the JAX package's experiments (``repro.experiments``) on the CPU at the
published settings — §3.2 polynomial regression (P 18, nu 0.1, 6000 steps,
batch 256) and §3.3 RICA (P 4, nu 0.01, 800 steps, batch 512, 64 x 48) —
and at the smaller regression setting the CPU test runs.  For each mode it
records the final W2 (regression) or the final objective and distance to
the optimum (RICA), and the speedup.

The band.  The port draws the unfused Langevin noise from a
``torch.Generator``, not ``jax.random.normal``; everything else (problem,
minibatches, delays, W-Icon's coordinate delays) is the same bits.  So a
final value of the port is one more draw from the law of that value under
the noise.  The script measures that law: it reruns each experiment with
``--replicates`` other chain keys (``PRNGKey(100 + r)`` in place of
``PRNGKey(seed + 1)``; the chain key also seeds W-Icon's coordinate
delays) and runs the port on the CPU at the same settings.  Each value's
band is a half-width ``b`` in log ratio around the reference, ``|ln(value /
reference)| <= b`` (the values are positive and spread by factors), with
``b`` twice the largest ``|ln(value / reference)|`` among the replicates and
the port's run.

Run from the repository root (about ten minutes on one CPU core)::

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/torch_paper_reference.py [--replicates 24]
"""

from __future__ import annotations

import argparse
import json
import math
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import samplers
from repro.core import (
    RICA,
    PolyRegression,
    WorkerModel,
    simulate_async,
    simulate_sync,
    speedup_vs_sync,
)
from repro.experiments import run_regression_experiment, run_rica_experiment
from repro.experiments.regression import _w2_curve

OUT = Path(__file__).resolve().parent.parent / "tests" / "fixtures" / "torch_paper_reference.json"
MODES = ("sync", "consistent", "inconsistent")
SETTINGS = {
    "regression": dict(P=18, nu=0.1, steps=6000, gamma=2e-4, sigma=1e-3,
                       batch=256, tau_cap=16, seed=0, modes=list(MODES)),
    "rica": dict(P=4, nu=0.01, steps=800, gamma=2e-3, batch=512, patch_dim=64,
                 num_features=48, tau_cap=8, seed=0, modes=list(MODES)),
    # what tests/test_torch_experiments.py runs on the CPU: the published
    # nu, gamma, sigma, batch and workers, a quarter of the steps, W-Icon
    "regression_test": dict(P=18, nu=0.1, steps=1500, gamma=2e-4, sigma=1e-3,
                            batch=256, tau_cap=16, seed=0,
                            modes=["inconsistent"]),
}
METRICS = {"regression": ("w2",), "regression_test": ("w2",),
           "rica": ("objective", "dist_to_opt")}
BAND_FACTOR = 2.0


def _commits(mode, s, tr_sync, tr_async):
    if mode == "sync":
        n = max(s["steps"] // s["P"], 1)
        return n, jnp.zeros((n,), jnp.int32)
    n = s["steps"]
    return n, jnp.asarray(np.minimum(tr_async.delays[:n], s["tau_cap"]))


def regression_finals(s, chain_seed):
    """Final W2 of each mode: ``run_regression_experiment`` with the chain
    key ``PRNGKey(chain_seed)``."""
    reg = PolyRegression.make(jax.random.PRNGKey(s["seed"]), nu_std=s["nu"])
    mu, cov, _ = reg.posterior_moments(sigma=s["sigma"])
    wm = WorkerModel(num_workers=s["P"], seed=s["seed"])
    tr_sync = simulate_sync(wm, max(s["steps"] // s["P"], 1), seed=s["seed"])
    tr_async = simulate_async(wm, s["steps"], seed=s["seed"])
    out = {}
    for mode in s["modes"]:
        n, delays = _commits(mode, s, tr_sync, tr_async)
        eff = s["batch"] * s["P"] if mode == "sync" else s["batch"]

        def grad(p, key, _b=eff):
            return jax.grad(reg.value)(p, reg.sample_batch(key, _b))

        sampler = samplers.sgld(mode, grad, gamma=s["gamma"], sigma=s["sigma"],
                                tau=s["tau_cap"] if mode != "sync" else 0)
        state = sampler.init(mu + 1.0, jax.random.PRNGKey(chain_seed))
        keys = jax.random.split(jax.random.PRNGKey(s["seed"] + 2), n)
        _, traj = jax.jit(lambda st: sampler.run(st, keys, delays))(state)
        _, w2 = _w2_curve(np.asarray(traj), mu, cov,
                          eval_every=max(10, n // 40),
                          window=max(50, min(400, n // 4)))
        out[mode] = {"w2": float(w2[-1])}
    return out


def rica_finals(s, chain_seed):
    """Final objective and distance of each mode: ``run_rica_experiment``
    with the chain key ``PRNGKey(chain_seed)`` (the optimum's run as
    there)."""
    rica = RICA(patch_dim=s["patch_dim"], num_features=s["num_features"])
    sigma = s["nu"] ** 2 / (2.0 * s["gamma"])
    w0 = rica.init_params(jax.random.PRNGKey(s["seed"]))
    wm = WorkerModel(num_workers=s["P"], cv=0.15, heterogeneity=0.05,
                     update_cost=0.15, seed=s["seed"])
    tr_sync = simulate_sync(wm, max(s["steps"] // s["P"], 1), seed=s["seed"])
    tr_async = simulate_async(wm, s["steps"], seed=s["seed"])

    def grad(p, key):
        return rica.grad(p, rica.sample_batch(key, s["batch"]))

    opt = samplers.sgld("sync", grad, gamma=s["gamma"], sigma=0.0)
    n_opt = 2 * s["steps"]
    keys_opt = jax.random.split(jax.random.PRNGKey(s["seed"] + 10), n_opt)
    opt_state, _ = jax.jit(lambda st: opt.run(
        st, keys_opt, jnp.zeros((n_opt,), jnp.int32), collect=False))(
        opt.init(w0, jax.random.PRNGKey(s["seed"] + 9)))
    w_ref = opt_state.params
    eval_batch = rica.sample_batch(jax.random.PRNGKey(s["seed"] + 11), 1024)
    out = {}
    for mode in s["modes"]:
        n, delays = _commits(mode, s, tr_sync, tr_async)
        eff = s["batch"] * s["P"] if mode == "sync" else s["batch"]

        def grad_m(p, key, _b=eff):
            return rica.grad(p, rica.sample_batch(key, _b))

        sampler = samplers.sgld(mode, grad_m, gamma=s["gamma"], sigma=sigma,
                                tau=s["tau_cap"] if mode != "sync" else 0)
        state = sampler.init(w0, jax.random.PRNGKey(chain_seed))
        keys = jax.random.split(jax.random.PRNGKey(s["seed"] + 2), n)
        _, traj = jax.jit(lambda st: sampler.run(st, keys, delays))(state)
        last = np.arange(0, n, max(5, n // 30))[-1]
        out[mode] = {"objective": float(rica.value(traj[last], eval_batch)),
                     "dist_to_opt": float(jnp.linalg.norm(traj[last] - w_ref))}
    return out


def reference(name, s):
    """The JAX package's own run at ``s``: final values and speedups."""
    kw = {k: v for k, v in s.items() if k != "modes"}
    if name == "rica":
        res = run_rica_experiment(**kw, modes=tuple(s["modes"]))
        return {m: {"objective": float(c.objective[-1]),
                    "dist_to_opt": float(c.dist_to_opt[-1]),
                    "speedup": c.speedup} for m, c in res.items()}
    res = run_regression_experiment(**kw, modes=tuple(s["modes"]))
    return {m: {"w2": float(c.w2[-1]), "speedup": c.speedup}
            for m, c in res.items()}


def port_cpu(name, s):
    from repro_torch.experiments import run_regression_experiment as treg
    from repro_torch.experiments import run_rica_experiment as trica

    kw = {k: v for k, v in s.items() if k != "modes"}
    if name == "rica":
        res = trica(**kw, modes=tuple(s["modes"]), device="cpu")
        return {m: {"objective": float(c.objective[-1]),
                    "dist_to_opt": float(c.dist_to_opt[-1]),
                    "speedup": c.speedup} for m, c in res.items()}
    res = treg(**kw, modes=tuple(s["modes"]), device="cpu")
    return {m: {"w2": float(c.w2[-1]), "speedup": c.speedup}
            for m, c in res.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--replicates", type=int, default=24)
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args()
    torch.set_num_threads(1)
    seeds = [100 + r for r in range(args.replicates)]
    doc = {"generated_by": "scripts/torch_paper_reference.py",
           "jax_version": jax.__version__, "torch_version": torch.__version__,
           "settings": SETTINGS, "replicate_chain_seeds": seeds,
           "band_rule": ("|ln(value / reference)| <= band; band = "
                         f"{BAND_FACTOR} x the largest |ln(value / reference)| "
                         "over the replicates and the port's CPU run"),
           "reference": {}, "replicates": {}, "port_cpu": {}, "band": {},
           "seconds": {}}
    for name, s in SETTINGS.items():
        finals = rica_finals if name == "rica" else regression_finals
        t0 = time.perf_counter()
        ref = reference(name, s)
        # the mirror above reproduces the package's run at its own key
        mirror = finals(s, s["seed"] + 1)
        for m in s["modes"]:
            for k in METRICS[name]:
                if not np.isclose(mirror[m][k], ref[m][k], rtol=1e-6):
                    raise SystemExit(f"{name} {m} {k}: mirror {mirror[m][k]} "
                                     f"!= reference {ref[m][k]}")
        reps = [finals(s, c) for c in seeds]
        t_jax = time.perf_counter() - t0
        t0 = time.perf_counter()
        port = port_cpu(name, s)
        t_port = time.perf_counter() - t0
        band = {}
        for m in s["modes"]:
            band[m] = {}
            for k in METRICS[name]:
                devs = [abs(math.log(r[m][k] / ref[m][k])) for r in reps + [port]]
                band[m][k] = BAND_FACTOR * max(devs)
            if port[m]["speedup"] != ref[m]["speedup"]:
                raise SystemExit(f"{name} {m}: speedup {port[m]['speedup']} != "
                                 f"{ref[m]['speedup']}")
        doc["reference"][name] = ref
        doc["replicates"][name] = {m: {k: [r[m][k] for r in reps]
                                       for k in METRICS[name]} for m in s["modes"]}
        doc["port_cpu"][name] = port
        doc["band"][name] = band
        doc["seconds"][name] = {"jax": t_jax, "port_cpu": t_port}
        print(json.dumps({name: {"reference": ref, "port_cpu": port,
                                 "band": band}}), flush=True)
    Path(args.out).write_text(json.dumps(doc, indent=1) + "\n")
    print("wrote", args.out)


if __name__ == "__main__":
    main()
