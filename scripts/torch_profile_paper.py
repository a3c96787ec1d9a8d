#!/usr/bin/env python3
"""Where the time of one commit of the paper's regression chain goes, for
the PyTorch/CUDA port.

Builds the §3.2 experiment's chain on the card at its published settings
(``repro_torch.experiments.regression``: the 5-parameter polynomial
regression, nu 0.1, gamma 2e-4, sigma 1e-3, batch 256, delays from 18
simulated workers capped at 16), unfused as the experiment runs it, and
for each mode:

- runs ``--warmup`` commits, then times ``--timed`` commits unprofiled
  (host clock, ending in a synchronise): ``unprofiled_ms`` a commit;
- profiles ``--commits`` commits with ``torch.profiler``: ``wall_ms`` a
  commit, ``device_busy_ms`` (the union of the kernel, copy and fill
  intervals on the card), ``idle_share`` = 1 - busy / wall, and
  ``kernels_per_commit`` (every launch on the card, PyTorch's included);
- the kernels launched most often, with their launches and device ms a
  commit.

It prints one JSON line a mode.  Run from the repository root on a machine
with an NVIDIA GPU::

    python3 scripts/torch_profile_paper.py [--modes inconsistent] [--commits 1]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent / "src"))
sys.path.insert(0, str(HERE))

from repro_torch import samplers  # noqa: E402
from repro_torch.core import PolyRegression, WorkerModel, simulate_async  # noqa: E402
from repro_torch.kernels import build, rng  # noqa: E402
from torch_profile_decode import DEVICE_CATS, busy_union  # noqa: E402

P, NU, GAMMA, SIGMA, BATCH, TAU = 18, 0.1, 2e-4, 1e-3, 256, 16


def chain(mode: str, n: int):
    """The experiment's chain for ``mode`` and its per-commit inputs."""
    reg = PolyRegression.make(rng.PRNGKey(0), nu_std=NU, device="cuda")
    mu = reg.posterior_moments(sigma=SIGMA)[0]
    is_sync = mode == "sync"
    b = BATCH * P if is_sync else BATCH

    def grad(p, key):
        return reg.grad(p, reg.sample_batch(key, b))

    sampler = samplers.sgld(mode, grad, gamma=GAMMA, sigma=SIGMA,
                            tau=0 if is_sync else TAU)
    delays = (np.zeros(n, np.int32) if is_sync else
              np.minimum(simulate_async(WorkerModel(num_workers=P), n).delays, TAU))
    return sampler, sampler.init(mu + 1.0, rng.PRNGKey(1)), \
        rng.split(rng.PRNGKey(2), n), delays


def profile_mode(mode: str, warmup: int, timed: int, commits: int) -> dict:
    n = warmup + timed + commits
    sampler, state, keys, delays = chain(mode, n)
    i = 0

    def run(k):
        nonlocal state, i
        state, _ = sampler.run(state, keys[i:i + k], delays[i:i + k],
                               collect=False)
        i += k

    run(warmup)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(timed)
    torch.cuda.synchronize()
    unprofiled = (time.perf_counter() - t0) / timed
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run(commits)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / commits
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    busy = busy_union(dev) / 1e3 / commits
    by_name = defaultdict(lambda: [0, 0.0])
    for e in dev:
        by_name[e["name"]][0] += 1
        by_name[e["name"]][1] += e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "mode": mode, "commit": (f"regression, published settings (P {P}, nu {NU}, "
                                 f"gamma {GAMMA}, sigma {SIGMA}, batch {BATCH}), unfused"),
        "commits_profiled": commits, "unprofiled_ms": unprofiled * 1e3,
        "wall_ms": wall * 1e3, "device_busy_ms": busy,
        "idle_share": 1.0 - busy / (wall * 1e3) if dev else None,
        "kernels_per_commit": len(dev) / commits,
        "top": [{"name": name[:90], "per_commit": c / commits,
                 "ms_per_commit": t / 1e3 / commits} for name, (c, t) in top],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--modes", nargs="+", default=["inconsistent"],
                    choices=["sync", "consistent", "inconsistent"])
    ap.add_argument("--warmup", type=int, default=50)
    ap.add_argument("--timed", type=int, default=200)
    ap.add_argument("--commits", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_paper: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()
    for mode in args.modes:
        print(json.dumps(profile_mode(mode, args.warmup, args.timed, args.commits)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
