"""Dry run: every (arch x shape) step on the ``meta`` device — counted
FLOPs and bytes, collective bytes, model FLOPs, memory and the H100
roofline terms, per device (port of ``repro.launch.dryrun``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mode pipeline]
        [--mesh 16x16 | --multi-pod] [--opts fsdp,window_slice,...]

It runs each step once on ``meta`` tensors (no memory, no device, no
placeholder devices, no compiler) under :func:`~repro_torch.launch.
flop_cost.step_cost` and writes one JSON per combination under ``--out``
(default ``dryrun_out/``, listed in ``.gitignore``): parameter counts and
bytes, the step's state, cache and batch bytes, ``model_flops``, the
counted FLOPs (matmul FLOPs apart), bytes and collective bytes, and the
roofline terms.

Without a mesh the step is one card's, the whole model.  ``--mesh DxM``
(``data`` x ``model``, or ``PxDxM`` with ``pod``) or ``--multi-pod`` (the
reference's 2 x 16 x 16) places it as the reference's dry run does on its
production mesh: in a fake world of that many ranks in this process
(:func:`~repro_torch.launch.mesh.fake_world`, destroyed before it returns),
rank 0 builds its placed model (``launch.steps.build_model(..., mesh=)``:
tensor-parallel, ``fsdp_tp``, or ``fsdp_full`` with ``--opts fsdp``) and
runs its own step on its ``meta`` blocks.  Rank 0 stands for every rank:
:func:`~repro_torch.models.common.sanitize_spec` leaves only dimensions
that divide evenly.  The parameter, state, cache and batch bytes are the
rank's blocks, the FLOPs and bytes its step's, and the collective bytes
what the port's collective helpers sent, by op and mesh axes
(:data:`~repro_torch.models.common.TRAFFIC`; collectives return at once in
a fake world).  The cache bytes are the rank's block of
:func:`~repro_torch.launch.steps.cache_spec_tree`'s placements; the step
itself decodes from the placed model's own cache (``cache_bytes_step``
where the two differ: a replicated K/V projection's rank keeps the KV
heads its queries read).  The placed model takes every config of the
registry in its own layout — hymba's SSD heads split by channel, the
xLSTM blocks replicated, a frontend's projection column-parallel — so a
combination is refused only where the port's placed model refuses it (a
MoE under ``fsdp``, as the reference asserts); it is then written with
``"refused"`` and its reason, and counted as such — never skipped.

Attention above 512 query positions (``prefill_32k``, ``train_4k``) goes
through ``scaled_dot_product_attention``.  Without a window it is one call,
which the count prices as a full ``S x S`` product (its causal mask
computed, then discarded) — on the card as on ``meta``; the reference's
chunked flash scan also visits every (query chunk, key chunk) pair and
masks, so at those lengths both count the full square.  With a window
(hymba-1.5b's 1,024) the port calls SDPA a query chunk at a time over the
in-window key chunks alone, ``--opts window_slice`` or not, so it counts
those; the reference's scan counts every pair unsliced, the in-window
ones sliced.  At up to 512 positions
both use plain attention and the matmul FLOPs are held equal
(``tests/test_torch_launch.py``).  Decode steps count the ring kernel at
every slot of the cache.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
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
    adapt_config,
    batch_specs,
    build_model,
    cache_spec_tree,
    make_decode_step,
    make_prefill_step,
    make_sgld_train_step,
    param_blocks,
)
from repro_torch.launch.steps import param_bytes as cfg_param_bytes
from repro_torch.models import common
from repro_torch.models.transformer import init_params

OUTDIR = "dryrun_out"


def _rows(batch: dict, mesh, placements: dict) -> dict:
    """The rank's block of each batch array (a host value as it is)."""
    from repro_torch.utils import local_block

    return {k: local_block(v, mesh, placements[k]) if hasattr(v, "shape") else v
            for k, v in batch.items()}


def step_and_args(cfg0, shape, *, mode: str = "sync", mesh=None, opts: tuple = ()):
    """``(step, args, cfg, memory dict)`` of one (arch, shape) on ``meta``:
    the whole step on one card, or on ``mesh`` (a ``DeviceMesh`` of a
    world, a fake one for the dry run) rank 0's placed step on its blocks."""
    from repro_torch.utils import local_block, tree_map

    model, cfg = build_model(cfg0, shape, opts, device="meta", mesh=mesh)
    whole = init_params(cfg, None, device="meta", num_chains=1)
    params = whole if mesh is None else param_blocks(whole, model)[0]
    mem = {"param_bytes": rl.tree_bytes(params)}
    baxes = model.batch_axes
    if shape.kind == "train":
        step = make_sgld_train_step(model, shape, mode=mode)
        batch = make_specs(cfg, shape)  # a placed rank takes its rows of each microbatch
        key = rng.PRNGKey(0)
        if mode == "pipeline":
            mem["state_bytes"] = mem["param_bytes"]  # the pending gradient
            args = (params, tree_map(lambda t: t.clone(), params), batch, key)
        else:
            args = (params, batch, key)
        held = batch if mesh is None else _rows(batch, mesh,
                                                batch_specs(cfg, shape, mesh, baxes)[1])
    elif shape.kind == "prefill":
        step = make_prefill_step(model)
        batch = make_specs(cfg, shape)
        if mesh is not None:
            batch = _rows(batch, mesh, batch_specs(cfg, shape, mesh, baxes)[1])
        args, held = (params, batch), batch
    else:
        step = make_decode_step(model)
        batch = make_specs(cfg, shape, kind="decode")
        if mesh is not None:
            batch = _rows(batch, mesh, batch_specs(cfg, shape, mesh, baxes, "decode")[1])
        cache = model.init_cache(batch["tokens"].shape[0], shape.seq_len,
                                 prefill_len=shape.seq_len - 1)
        mem["cache_bytes"] = rl.tree_bytes(cache)
        if mesh is not None:
            whole_cache, placed = cache_spec_tree(model, cfg, shape, mesh, baxes)
            mem["cache_bytes"] = rl.tree_bytes(tree_map(
                lambda t, pl: local_block(t, mesh, pl), whole_cache, placed))
            if rl.tree_bytes(cache) != mem["cache_bytes"]:
                mem["cache_bytes_step"] = rl.tree_bytes(cache)
        args, held = (params, cache, batch), batch
    mem["batch_bytes"] = rl.tree_bytes(held)
    return step, args, cfg, mem


def _mesh_name(mesh) -> str:
    return "1" if mesh is None else "x".join(str(n) for n in mesh.mesh.shape)


def run_combo(arch_id: str, shape_name: str, *, mode: str = "sync", mesh=None,
              opts: tuple = (), shape=None, cfg0=None, verbose: bool = True) -> dict:
    """Count one combination on ``meta``; returns its result dict (with
    ``"refused"`` and the reason where the port's placed model refuses it).
    ``mesh``: None for one card, else a ``DeviceMesh`` of the running
    world (:func:`~repro_torch.launch.mesh.fake_world`).  ``shape`` /
    ``cfg0`` (optional) replace the named ones (tests pass reduced
    ones)."""
    shape = shape or get_shape(shape_name)
    cfg0 = cfg0 or get_arch(arch_id)
    canon = ALIASES.get(arch_id, arch_id).replace("-", "_").replace(".", "p")
    n = 1 if mesh is None else mesh.mesh.numel()
    result = {"arch": canon, "shape": shape.name, "mesh": _mesh_name(mesh),
              "mode": mode + "".join(f"+{o}" for o in opts), "kind": shape.kind,
              "num_devices": n}
    t0 = time.perf_counter()
    try:
        step, args, cfg, mem = step_and_args(cfg0, shape, mode=mode, mesh=mesh, opts=opts)
    except ValueError as e:  # the port's placed model refuses this combination
        result["refused"] = str(e)
        with contextlib.suppress(ValueError):  # the bytes the layout would hold
            cfg = adapt_config(cfg0, shape, opts)
            result["memory"] = {"param_bytes": cfg_param_bytes(cfg, mesh) if mesh
                                is not None else rl.tree_bytes(init_params(cfg, None, device="meta"))}
        if verbose:
            print(json.dumps({k: result[k] for k in ("arch", "shape", "mesh", "mode",
                                                     "refused")}), flush=True)
        return result
    common.reset_collectives()
    cost = step_cost(step, *args)
    traffic = {f"{op} over {'+'.join(axes) or '-'}": {"calls": c, "bytes": b}
               for (op, axes), (c, b) in sorted(common.TRAFFIC.items())}
    common.reset_collectives()
    seconds = time.perf_counter() - t0
    mf = rl.model_flops(cfg, shape)
    coll = sum(v["bytes"] for v in traffic.values())
    roof = rl.analyze(f"{arch_id}/{shape.name}", cost, mf, n, coll)
    result.update({
        "param_sharding": cfg.param_sharding,
        "seconds": seconds,
        "sliding_window": cfg.sliding_window,
        "memory": mem,
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
        "counted": {"flops": cost.flops, "matmul_flops": cost.matmul_flops,
                    "bytes": cost.bytes},
        "collectives": traffic,
        "roofline": {
            "card": roof.card,
            "peak_flops": rl.PEAK_FLOPS,
            "hbm_bytes_per_s": rl.HBM_BW,
            "link": roof.link,
            "flops_per_device": roof.flops_per_device,
            "bytes_per_device": roof.bytes_per_device,
            "collective_bytes_per_device": roof.collective_bytes_per_device,
            "t_compute": roof.t_compute,
            "t_memory": roof.t_memory,
            "t_collective": roof.t_collective,
            "dominant": roof.dominant,
            "model_flops_global": roof.model_flops_global,
            "counted_flops_global": roof.counted_flops_global,
            "useful_ratio": roof.useful_ratio,
        },
    })
    if verbose:
        print(json.dumps({k: result[k] for k in ("arch", "shape", "mesh", "mode",
                                                 "seconds")}), flush=True)
        print(" ", roof.summary(), flush=True)
    return result


def save_result(result: dict, outdir: str = OUTDIR) -> str:
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, f"{result['arch']}__{result['shape']}__"
                                f"{result['mesh']}__{result['mode']}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=2)
    return path


@contextlib.contextmanager
def placed(shape: tuple | None):
    """The mesh of ``shape`` (``(data, model)`` or ``(pod, data, model)``)
    in a fake world of its size, destroyed on exit; None: one card, no
    world."""
    from repro_torch.launch.mesh import _mesh, fake_world

    if shape is None:
        yield None
        return
    names = ("pod", "data", "model")[-len(shape):]
    with fake_world(math.prod(shape)):
        yield _mesh(tuple(shape), names)


def parse_mesh(text: str) -> tuple:
    parts = tuple(int(p) for p in text.lower().split("x"))
    if len(parts) not in (2, 3) or min(parts) < 1:
        raise argparse.ArgumentTypeError(
            f"--mesh takes DATAxMODEL or PODxDATAxMODEL, got {text!r}")
    return parts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id (see configs)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mode", default="sync", choices=["sync", "pipeline"])
    ap.add_argument("--mesh", type=parse_mesh, default=None,
                    help="place the step on a DATAxMODEL (or PODxDATAxMODEL) mesh")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the reference's 2x16x16 production mesh")
    ap.add_argument("--opts", default="",
                    help="comma list of the reference's switches: "
                         "attn_shard,window_slice,fsdp,unroll,padvocab")
    ap.add_argument("--out", default=OUTDIR)
    args = ap.parse_args(argv)
    if args.multi_pod and args.mesh:
        ap.error("--multi-pod is the 2x16x16 mesh: give it or --mesh, not both")

    if args.all:
        combos = [(a, s) for a in ARCH_IDS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        combos = [(args.arch, args.shape)]
    opts = tuple(o for o in args.opts.split(",") if o)
    mesh_shape = (2, 16, 16) if args.multi_pod else args.mesh

    failures, refused = [], []
    t0 = time.perf_counter()
    with placed(mesh_shape) as mesh:
        for arch, shape in combos:
            try:
                res = run_combo(arch, shape, mode=args.mode, mesh=mesh, opts=opts)
                save_result(res, args.out)
                if "refused" in res:
                    refused.append((arch, shape, res["refused"]))
            except Exception as e:  # noqa: BLE001 — report and continue
                traceback.print_exc()
                failures.append((arch, shape, repr(e)))
    if failures:
        print(f"FAILED {len(failures)}/{len(combos)}:", failures)
        return 1
    print(f"OK: {len(combos)} combinations on meta in {time.perf_counter() - t0:.1f} s "
          f"({len(combos) - len(refused)} counted, {len(refused)} refused)")
    for arch, shape, why in refused:
        print(f"  refused {arch} {shape}: {why}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
