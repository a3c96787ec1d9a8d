"""Dry run: every (arch x shape) step on the ``meta`` device — counted
FLOPs and bytes, model FLOPs, memory and the H100 roofline terms (port of
``repro.launch.dryrun``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mode pipeline] [--devices 256]

It runs each step once on ``meta`` tensors (no memory, no device, no
placeholder devices, no compiler) under :func:`~repro_torch.launch.
flop_cost.step_cost` and writes one JSON per combination under ``--out``
(default ``dryrun_out/``, listed in ``.gitignore``): parameter counts and
bytes, the step's state, cache and batch bytes, ``model_flops``, the
counted FLOPs (matmul FLOPs apart) and bytes, and the roofline terms.
Per-device figures split the global counts evenly over ``--devices``, a
nominal mesh size (1 by default: one card); nothing is sharded.

Attention above 512 query positions (``prefill_32k``, ``train_4k``) goes
through ``scaled_dot_product_attention``, which the count prices as a full
``S x S`` product (its causal mask computed, then discarded) — on the
card as on ``meta``.  The reference's chunked flash scan also visits every
(query chunk, key chunk) pair and masks, so at those lengths both count
the full square; at up to 512 positions both use plain attention and the
matmul FLOPs are held equal (``tests/test_torch_launch.py``).  Decode
steps count the ring kernel at every slot of the cache.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

from repro_torch.configs import ARCH_IDS, SHAPES, get_arch, get_shape
from repro_torch.configs.base import ALIASES
from repro_torch.data import make_specs
from repro_torch.kernels import rng
from repro_torch.launch import roofline as rl
from repro_torch.launch.flop_cost import step_cost
from repro_torch.launch.steps import (
    build_model,
    make_decode_step,
    make_prefill_step,
    make_sgld_train_step,
)
from repro_torch.models.transformer import init_params

OUTDIR = "dryrun_out"


def step_and_args(cfg0, shape, *, mode: str = "sync"):
    """``(step, args, cfg, memory dict)`` of one (arch, shape) on ``meta``."""
    model, cfg = build_model(cfg0, shape, device="meta")
    params = init_params(cfg, device="meta", num_chains=1)
    mem = {"param_bytes": rl.tree_bytes(params)}
    if shape.kind == "train":
        step = make_sgld_train_step(model, shape, mode=mode)
        batch = make_specs(cfg, shape)
        key = rng.PRNGKey(0)
        if mode == "pipeline":
            mem["state_bytes"] = mem["param_bytes"]  # the pending gradient
            args = (params, init_params(cfg, device="meta", num_chains=1), batch, key)
        else:
            args = (params, batch, key)
    elif shape.kind == "prefill":
        step = make_prefill_step(model)
        batch = make_specs(cfg, shape)
        args = (params, batch)
    else:
        step = make_decode_step(model)
        batch = make_specs(cfg, shape, kind="decode")
        cache = model.init_cache(shape.global_batch, shape.seq_len,
                                 prefill_len=shape.seq_len - 1)
        mem["cache_bytes"] = rl.tree_bytes(cache)
        args = (params, cache, batch)
    mem["batch_bytes"] = rl.tree_bytes(batch)
    return step, args, cfg, mem


def run_combo(arch_id: str, shape_name: str, *, mode: str = "sync",
              num_devices: int = 1, shape=None, cfg0=None, verbose: bool = True) -> dict:
    """Count one combination on ``meta``; returns its result dict.  ``shape``
    / ``cfg0`` (optional) replace the named ones (tests pass reduced
    ones)."""
    shape = shape or get_shape(shape_name)
    cfg0 = cfg0 or get_arch(arch_id)
    t0 = time.perf_counter()
    step, args, cfg, mem = step_and_args(cfg0, shape, mode=mode)
    cost = step_cost(step, *args)
    seconds = time.perf_counter() - t0
    mf = rl.model_flops(cfg, shape)
    roof = rl.analyze(f"{arch_id}/{shape.name}", cost, num_devices, mf)
    canon = ALIASES.get(arch_id, arch_id).replace("-", "_").replace(".", "p")
    result = {
        "arch": canon,
        "shape": shape.name,
        "mode": mode,
        "kind": shape.kind,
        "num_devices": num_devices,
        "seconds": seconds,
        "sliding_window": cfg.sliding_window,
        "memory": mem,
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
        "counted": {"flops": cost.flops, "matmul_flops": cost.matmul_flops,
                    "bytes": cost.bytes},
        "roofline": {
            "card": roof.card,
            "peak_flops": rl.PEAK_FLOPS,
            "hbm_bytes_per_s": rl.HBM_BW,
            "flops_per_device": roof.flops_per_device,
            "bytes_per_device": roof.bytes_per_device,
            "t_compute": roof.t_compute,
            "t_memory": roof.t_memory,
            "dominant": roof.dominant,
            "model_flops_global": roof.model_flops_global,
            "counted_flops_global": roof.counted_flops_global,
            "useful_ratio": roof.useful_ratio,
        },
    }
    if verbose:
        print(json.dumps({k: result[k] for k in ("arch", "shape", "mode", "seconds")}),
              flush=True)
        print(" ", roof.summary(), flush=True)
    return result


def save_result(result: dict, outdir: str = OUTDIR) -> str:
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, f"{result['arch']}__{result['shape']}__"
                                f"{result['mode']}__{result['num_devices']}dev.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=2)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id (see configs)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mode", default="sync", choices=["sync", "pipeline"])
    ap.add_argument("--devices", type=int, default=1,
                    help="nominal mesh size the per-device figures split over")
    ap.add_argument("--out", default=OUTDIR)
    args = ap.parse_args(argv)

    if args.all:
        combos = [(a, s) for a in ARCH_IDS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        combos = [(args.arch, args.shape)]

    failures = []
    t0 = time.perf_counter()
    for arch, shape in combos:
        try:
            save_result(run_combo(arch, shape, mode=args.mode,
                                  num_devices=args.devices), args.out)
        except Exception as e:  # noqa: BLE001 — report and continue
            traceback.print_exc()
            failures.append((arch, shape, repr(e)))
    if failures:
        print(f"FAILED {len(failures)}/{len(combos)}:", failures)
        return 1
    print(f"OK: {len(combos)} combinations counted on meta in "
          f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
