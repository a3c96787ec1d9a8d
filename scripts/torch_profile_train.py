#!/usr/bin/env python3
"""Where the time of one training commit goes, for the PyTorch/CUDA port.

Builds the launcher's full-width run on the card — one qwen3-4b chain
(bf16, random weights from a seeded ``torch.Generator``), W-Icon delayed
reads, the fused commit, tau 2, batch 8 x 128 tokens
(``repro_torch.launch.train --mode inconsistent --fused --tau 2``) — runs
two commits to warm up, and profiles ``--steps`` commits, one
``Engine.run`` each at the trace's worst staleness (delay 2), with
``torch.profiler``.  It prints one JSON line:

- ``wall_ms``: host clock per commit, the commit ending in a synchronise;
- ``device_busy_ms``: per commit, the union of the kernel, copy and fill
  intervals on the card, and ``idle_share`` = 1 - busy / wall;
- ``kernels_per_commit``;
- ``shares``: each part's device time over the busy time — the Langevin
  update, the W-Icon read (the one-pass ``wicon_kernel``; in a tree from
  before it, the delay draw and the gather), the GEMMs (cuBLAS), copies
  and fills, and the rest (elementwise, norms, softmax, reductions) — and
  ``ms`` per commit for each;
- ``per_leaf_ms``: each SGLD kernel's time on each parameter leaf (the
  first profiled commit, leaves in JAX's order, with their sizes; the
  W-Icon read one launch a leaf);
- the kernels with the most device time.

Run from the repository root on a machine with an NVIDIA GPU::

    python3 scripts/torch_profile_train.py [--steps 2]
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

import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent / "src"))
sys.path.insert(0, str(HERE))

from repro_torch.kernels import build, rng  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.utils import tree_flatten  # noqa: E402
from torch_profile_decode import DEVICE_CATS, busy_union  # noqa: E402

PARTS = (("update", ("langevin_update_kernel",)),
         ("wicon_read", ("wicon_kernel", "delay_gather_kernel",
                         "coordinate_delays_kernel")),
         ("gemm", ("gemm", "nvjet", "xmma", "cutlass")))


def part_of(event) -> str:
    if event.get("cat") in ("gpu_memcpy", "gpu_memset"):
        return "copy_fill"
    name = event["name"].lower()
    for part, keys in PARTS:
        if any(k in name for k in keys):
            return part
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_train: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()
    run = launch.parser().parse_args(
        ["--arch", "qwen3-4b", "--mode", "inconsistent", "--fused", "--tau", "2",
         "--batch", "8", "--seq", "128", "--steps", "1"])
    _, _, state, engine, _, key = launch.build(run)
    engine.hooks = []
    holder = [state, key]

    def commit():
        holder[1], k = rng.split(holder[1])  # each commit its own batch
        holder[0], _ = engine.run(holder[0], steps=1, delays=[2], key=k)

    for _ in range(2):
        commit()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            commit()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.steps
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    busy = busy_union(dev) / 1e3 / args.steps
    parts, by_name = defaultdict(float), defaultdict(lambda: [0, 0.0])
    for e in dev:
        parts[part_of(e)] += e["dur"] / 1e3 / args.steps
        by_name[e["name"]][0] += 1
        by_name[e["name"]][1] += e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    leaves = tree_flatten(holder[0].params)[0]
    n_leaves = len(leaves)
    per_leaf = {}
    for part in ("wicon_read", "update"):
        launches = sorted((e for e in dev if part_of(e) == part),
                          key=lambda e: e["ts"])[:n_leaves]
        per_leaf[part] = [round(e["dur"] / 1e3, 4) for e in launches]
    per_leaf["numel"] = [t.numel() for t in leaves]
    print(json.dumps({
        "commit": "fused W-Icon, qwen3-4b full width, tau 2, batch 8 x 128",
        "steps": args.steps, "wall_ms": wall * 1e3, "device_busy_ms": busy,
        "idle_share": 1.0 - busy / (wall * 1e3) if dev else None,
        "kernels_per_commit": len(dev) / args.steps,
        "ms": dict(parts), "shares": {k: v / busy for k, v in parts.items()},
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "per_leaf_ms": per_leaf,
        "top": [{"name": n[:90], "per_commit": c / args.steps,
                 "ms_per_commit": t / 1e3 / args.steps}
                for n, (c, t) in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
