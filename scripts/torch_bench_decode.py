#!/usr/bin/env python3
"""Time the port's two decode kernels at the main path's and long-context
shapes, on one NVIDIA GPU, for one or more copies of the package.

    python3 scripts/torch_bench_decode.py [--src DIR ...] [--iters N] [--engines]

Each ``--src`` is a ``src`` directory holding ``repro_torch`` (default: this
checkout's).  Giving two, e.g. an unpacked parent commit's and this one's,
as ``--src A --src B --src B --src A`` times them in turns in one process on
one card, so they can be compared.  Each source is run in its own
subprocess, so that its kernels are built from its own ``csrc/``.

Cases: ``chip_smoke.py``'s timed ones (``RING_CASES``, ``PAGED_CASES``;
qwen3-4b: 8 KV heads, 4 query heads a KV head, head_dim 128, bf16): ring
steps over 16 rows (4 chains x 4) at the decode cell's 256-slot ring with
48 valid rows, a full 1024-slot ring and a full 16,384-slot ring; paged
steps over 4 chains x 8 slots, page size 16, at the paged cell's positions
(16 pages a slot) and over 4,096-position windows (256 pages a slot).
With ``--engines`` it runs, for each source, that tree's own
``chip_smoke.main_path`` instead (``DecodeEngine`` and ``PagedDecodeEngine``
over a 4-chain full-width qwen3-4b bank, ``chip_smoke.py`` phases 4-5) and
prints its ms per token and tokens per second: host-bound numbers, so
compare trees only in turns within one call.

Inputs come from ``chip_smoke.py``'s generators; each time is the mean of
CUDA-event-timed calls that cycle through input sets larger than the L2
cache: ``ms`` from replays of a CUDA graph of the calls (device time),
``eager_ms`` from calls enqueued one by one (which times the host where it
enqueues slower than the card runs).  A case the kernel refuses is
reported as refused.  Prints the card's name and power limit, then one
JSON object a line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def run_one(src: str, iters: int) -> None:
    import torch

    sys.path.insert(0, src)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import decode_step as ds

    dtype = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(0)
    for smax, n_valid, slot in cs.RING_CASES:
        N = 16
        row = 8 * 128 * 2
        sets = [cs.decode_inputs(torch, gen, dtype, N, smax, n_valid, slot)
                for _ in range(cs.n_sets(2 * N * smax * row))]
        fns = [lambda s=s: ds.decode_step(s["q"], s["k_new"], s["v_new"],
                                          s["k_cache"], s["v_cache"],
                                          s["valid"], slot) for s in sets]
        res = {"src": src, "kernel": "decode_step", "smax": smax,
               "valid": n_valid}
        try:
            res["ms"] = cs.graph_ms(torch, fns, iters)
            res["eager_ms"] = cs.cuda_ms(torch, fns, iters)
        except ValueError as e:
            res["refused"] = str(e)
        print(json.dumps(res), flush=True)
        del sets, fns
        torch.cuda.empty_cache()
    for pos, maxp in cs.PAGED_CASES:
        C = 4
        probe = cs.paged_inputs(torch, gen, dtype, C, pos, maxp=maxp)
        pool = 2 * probe["k_pages"].numel() * 2
        sets = [probe] + [cs.paged_inputs(torch, gen, dtype, C, pos, maxp=maxp)
                          for _ in range(cs.n_sets(pool) - 1)]
        fns = [lambda s=s: ds.paged_decode_step(
            s["q"], s["k_new"], s["v_new"], s["k_pages"], s["v_pages"],
            s["tables"], s["pos"]) for s in sets]
        res = {"src": src, "kernel": "paged_decode_step", "maxp": maxp}
        try:
            res["ms"] = cs.graph_ms(torch, fns, iters)
            res["eager_ms"] = cs.cuda_ms(torch, fns, iters)
        except ValueError as e:
            res["refused"] = str(e)
        print(json.dumps(res), flush=True)
        del sets, fns, probe
        torch.cuda.empty_cache()


def run_engines(src: str) -> None:
    import importlib.util

    import numpy as np
    import torch

    sys.path.insert(0, src)
    spec = importlib.util.spec_from_file_location(
        "tree_chip_smoke", Path(src).parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from repro_torch.configs import get_arch
    from repro_torch.kernels import decode_step as ds

    out = cs.main_path(torch, np, ds, get_arch("qwen3-4b"))
    print(json.dumps({"src": src, "decode_ms_per_token": out["decode"]["per_token_ms"],
                      "paged_tokens_per_s": out["paged"]["tokens_per_s"],
                      "decode_launches": out["decode"]["launches"],
                      "paged_launches": out["paged"]["launches"]}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append",
                    help="a src directory holding repro_torch (repeatable)")
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--engines", action="store_true",
                    help="time the two engines (chip_smoke phases 4-5) instead")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one and args.engines:
        run_engines(args.one)
        return 0
    if args.one:
        run_one(args.one, args.iters)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    for src in args.src or [str(ROOT / "src")]:
        subprocess.run([sys.executable, __file__, "--one",
                        str(Path(src).resolve()), "--iters", str(args.iters)]
                       + (["--engines"] if args.engines else []), check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
