#!/usr/bin/env python3
"""Where the time of one decode step goes, for the PyTorch/CUDA port.

Builds the 4-chain full-width qwen3-4b bank on the card (bf16, random
weights from a seeded ``torch.Generator``), warms up, and profiles
``--steps`` steps each of ``Model.serve_step`` (the ``DecodeEngine`` step,
4 rows) and ``Model.paged_step`` (the ``PagedDecodeEngine`` micro-step,
8 slots) with ``torch.profiler``; with ``--serve``, ``ServeEngine``
requests instead (``transformer_next_token_predict``: 8 prompts of 1,024
tokens, the long-prompt SDPA path, and 8 of 128 tokens, the naive path).
For each it prints one JSON line:

- ``wall_ms``: host clock per step, the step ending in a synchronise;
- ``device_busy_ms``: per step, the union of the kernel intervals on the
  card (so overlapping kernels count once), and ``idle_share`` = 1 -
  busy / wall;
- ``kernels_per_step`` and the kernels with the most device time;
- ``attention_kernels``: the kernels whose names say they are SDPA's
  (which backend ran: flash, memory-efficient or the math path's GEMMs).

Run from the repository root on a machine with an NVIDIA GPU::

    python3 scripts/torch_profile_decode.py [--steps 5] [--serve]
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

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.cluster import ServeEngine  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models import transformer_next_token_predict  # noqa: E402
from repro_torch.models.transformer import Model, init_params  # noqa: E402

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def busy_union(events) -> float:
    """Total length (us) of the union of [ts, ts + dur) intervals."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    total, end = 0.0, -1.0
    for a, b in spans:
        if a >= end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def profile(name: str, step, steps: int) -> dict:
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    by_name = defaultdict(lambda: [0, 0.0])
    for e in dev:
        by_name[e["name"]][0] += 1
        by_name[e["name"]][1] += e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    busy = busy_union(dev) / 1e3 / steps
    attn = sorted(n for n in by_name
                  if any(w in n.lower() for w in ("flash", "fmha", "attention", "efficient")))
    return {
        "step": name, "steps": steps, "wall_ms": wall * 1e3,
        "device_busy_ms": busy,
        "idle_share": 1.0 - busy / (wall * 1e3) if dev else None,
        "kernels_per_step": len(dev) / steps,
        "top": [{"name": n[:90], "per_step": c / steps, "ms_per_step": t / 1e3 / steps}
                for n, (c, t) in top],
        "attention_kernels": [{"name": n[:160], "per_step": by_name[n][0] / steps,
                               "ms_per_step": by_name[n][1] / 1e3 / steps} for n in attn],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--serve", action="store_true",
                    help="profile ServeEngine requests instead of decode steps")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_decode: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    build.build()
    cfg = get_arch("qwen3-4b")
    C = 4
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda", num_chains=C)
    model = Model(cfg)
    rng = np.random.default_rng(0)
    if args.serve:
        serve = ServeEngine(predict_fn=transformer_next_token_predict(model), params=params)
        for T in (1024, 128):
            prompts = {"tokens": rng.integers(0, cfg.vocab_size, (8, T)).astype(np.int32)}
            res = profile(f"serve_request_8x{T}", lambda p=prompts: serve(p), args.steps)
            print(json.dumps(res))
        return 0

    # the DecodeEngine step: 4 rows, a 256-slot ring, position 40
    cache = model.init_cache_bank(C, 4, 256)
    prompt = rng.integers(0, cfg.vocab_size, (4, 40)).astype(np.int32)
    tok = torch.as_tensor(prompt[:, -1:], device="cuda")
    with torch.no_grad():
        model.prefill_cache(params, prompt, cache, 40)
        res = profile("serve_step", lambda: model.serve_step(params, cache, tok, 40),
                      args.steps)
    print(json.dumps(res))

    # the PagedDecodeEngine micro-step: 8 slots of 16-token pages
    S, ps, maxp = 8, 16, 16
    pages = model.init_paged_bank(C, S * maxp + 1, ps)
    tables = torch.arange(1, S * maxp + 1, dtype=torch.int32,
                          device="cuda").reshape(S, maxp)
    pos = torch.tensor([40, 95, 130, 7, 200, 60, 20, 250], dtype=torch.int32,
                       device="cuda")
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (S, 1)), device="cuda")
    with torch.no_grad():
        res = profile("paged_step",
                      lambda: model.paged_step(params, pages, tables, toks, pos),
                      args.steps)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
