#!/usr/bin/env python3
"""Where the time of one ``ClusterEngine`` commit goes, for the PyTorch/CUDA
port: the cluster cells of ``chip_smoke.py`` phase 8.

- ``full``: 4 chains of qwen3-4b at its published widths and 4 layers
  (bf16, random weights from a seeded ``torch.Generator``), fused W-Icon at
  tau 2, a batch of 8 x 128 tokens a chain; one commit warms up, then
  ``--steps`` commits are profiled in one ``run`` at staleness 0, 1, 2, 2,
  ... (a run's first commits cannot be staler than their index), every
  chain alike, one commit a chunk.
- ``full-health``: the same under ``health_check=True`` (no fault
  injected): each commit's ``(C,)`` non-finite flags come back to the
  host, one read a commit.
- ``quickstart``: the torch cluster quickstart's 32 chains of a d=2
  quadratic (``examples/torch_cluster_quickstart.py``), sgld W-Con and the
  fused W-Icon preset; 50 commits warm up, then ``--quick-steps`` commits
  are profiled in one ``run``.

One JSON line a cell: ``wall_ms`` (host clock a commit, ending in a
synchronise), ``device_busy_ms`` (the union of the kernel, copy and fill
intervals on the card a commit) and ``idle_share`` = 1 - busy / wall,
``kernels_per_commit``, ``host_syncs_per_commit`` (the host's
``cudaStreamSynchronize`` and ``cudaDeviceSynchronize`` calls a commit,
the run's closing synchronise included: a copy from pageable host memory
ends in one), each part's ``ms`` a commit (the Langevin update, the W-Icon
read, GEMMs, copies and fills, the rest), ``peak_gb``, and the kernels
with the most device time.

Run from the repository root on a machine with an NVIDIA GPU::

    python3 scripts/torch_profile_cluster.py [--cells full full-health quickstart] [--steps 4]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent / "src"))
sys.path.insert(0, str(HERE.parent / "examples"))
sys.path.insert(0, str(HERE))

from repro_torch import samplers  # noqa: E402
from repro_torch.cluster import ClusterEngine, WorkerSchedule  # noqa: E402
from repro_torch.configs import ShapeConfig, get_arch  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.kernels import build, rng  # noqa: E402
from repro_torch.models.transformer import Model, init_params  # noqa: E402
from repro_torch.train.loop import make_grad_fn  # noqa: E402
from torch_profile_decode import DEVICE_CATS, busy_union  # noqa: E402

PARTS = (("update", ("langevin_update",)),
         ("wicon_read", ("wicon", "delay_gather", "coordinate_delays")),
         ("gemm", ("gemm", "nvjet", "xmma", "cutlass")))


def part_of(event) -> str:
    if event.get("cat") in ("gpu_memcpy", "gpu_memset"):
        return "copy_fill"
    name = event["name"].lower()
    for part, keys in PARTS:
        if any(k in name for k in keys):
            return part
    return "other"


def profile(cell: str, run, steps: int) -> dict:
    """Profile ``run()`` (``steps`` commits) and reduce the trace."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    syncs = sum(e.get("name") in ("cudaStreamSynchronize", "cudaDeviceSynchronize")
                for e in events)
    busy = busy_union(dev) / 1e3 / steps
    parts, by_name = defaultdict(float), defaultdict(lambda: [0, 0.0])
    for e in dev:
        parts[part_of(e)] += e["dur"] / 1e3 / steps
        by_name[e["name"]][0] += 1
        by_name[e["name"]][1] += e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {"cell": cell, "steps": steps, "wall_ms": wall * 1e3,
            "device_busy_ms": busy,
            "idle_share": 1.0 - busy / (wall * 1e3) if dev else None,
            "kernels_per_commit": len(dev) / steps,
            "host_syncs_per_commit": syncs / steps, "ms": dict(parts),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "top": [{"name": n[:90], "per_commit": c / steps,
                     "ms_per_commit": t / 1e3 / steps} for n, (c, t) in top]}


def full_cell(steps: int, health: bool = False) -> dict:
    C, tau = 4, 2
    cfg = replace(get_arch("qwen3-4b"), num_layers=4)
    shape = ShapeConfig("cluster", seq_len=128, global_batch=8, kind="train")
    sampler = samplers.sgld("inconsistent", make_grad_fn(Model(cfg, device="cuda")),
                            gamma=1e-3, sigma=1e-5, tau=tau, has_aux=True, fused=True)
    engine = ClusterEngine(sampler, num_chains=C, chunk_size=1, health_check=health,
                           batch_fn=lambda g: make_batch(cfg, shape, g, "train"))
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda", num_chains=1)
    holder = [engine.init(params, rng.PRNGKey(0))]
    del params
    gen = torch.Generator().manual_seed(0)
    holder[0], _ = engine.run(holder[0], steps=1, key=gen)
    delays = np.minimum(np.arange(steps), tau)

    def run():
        holder[0], _ = engine.run(holder[0], steps=steps,
                                  schedule=WorkerSchedule.from_delays(delays), key=gen)

    torch.cuda.reset_peak_memory_stats()
    out = profile(f"full{'-health' if health else ''}: 4 x qwen3-4b at 4 layers, "
                  f"fused W-Icon, tau 2, 8 x 128, delays {delays.tolist()}", run, steps)
    del holder[0]
    return out


def quickstart_cells(steps: int) -> list:
    import torch_cluster_quickstart as qs

    out = []
    for name, fused in (("sgld W-Con", False), ("fused W-Icon", True)):
        engine, state, schedules, _ = qs.build_ensemble("sgld", device="cuda", fused=fused)
        engine.hooks = []
        state, _ = engine.run(state, steps=50, schedule=schedules)
        holder = [state]

        def run():
            holder[0], _ = engine.run(holder[0], steps=steps, schedule=schedules)

        out.append(profile(f"quickstart: 32 chains, d=2 quadratic, {name}", run, steps))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", nargs="+", default=["full", "quickstart"],
                    choices=["full", "full-health", "quickstart"])
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--quick-steps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_cluster: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()
    rows = []
    if "quickstart" in args.cells:
        rows += quickstart_cells(args.quick_steps)
    for cell in ("full", "full-health"):
        if cell in args.cells:
            rows.append(full_cell(args.steps, health=cell == "full-health"))
            torch.cuda.empty_cache()
    for row in rows:
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
