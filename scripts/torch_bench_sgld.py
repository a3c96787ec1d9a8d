#!/usr/bin/env python3
"""Time the port's SGLD kernels on the largest full-width leaf, on one NVIDIA
GPU, for one or more copies of the package.

    python3 scripts/torch_bench_sgld.py [--src DIR ...] [--iters N] [--sass] [--train]

Each ``--src`` is a ``src`` directory holding ``repro_torch`` (default: this
checkout's); a tree whose kernels take a chain axis is timed on one chain
(C = 1), with its parameter tables made before the timing.  Giving two, e.g. an unpacked parent commit's and this one's,
as ``--src A --src B --src B --src A`` times them in turns in one call on
one card, so they can be compared.  Each source runs in its own
subprocess, so that its kernels are built from its own ``csrc/``.

On qwen3-4b's largest leaf (36 x 2560 x 9728 = 896.5 M bf16 elements,
``chip_smoke.LARGEST_LEAF``) and a 3-slot ring of it, it times with CUDA
events, as the mean of back-to-back calls (``chip_smoke.cuda_ms``):

- ``langevin_update``: the fused commit, in place;
- ``coordinate_delays``: the delay draw alone (maxval 3);
- ``delay_gather``: the gather from a delay array;
- ``wicon_read``: the W-Icon read as the training path runs it — one
  kernel where the tree has ``wicon_read``, else the draw then the gather
  (``kernels`` says which) — at maxval 3 and at maxval 2;

each beside its bound as ``chip_smoke.py`` computes it, and the issue
slots an element that its time implies (ms x 132 SMs x 128 lanes x the
SM's maximum clock, over the elements: a lower bound on the time's worth
of instructions, reached only when every scheduler issues every cycle).
Then the gather and the read once each, one call at a time: after a
synchronise (``single_ms``) and right after a parameter-size copy (8.82 GB
of bf16, as the ring push makes in a commit; ``after_copy_ms``), the
question of PERF.md section 7.

``--sass`` also disassembles the tree's built kernels (``cuobjdump -sass``)
and prints, for each kernel and each loop in it (a backward branch and its
target), the instructions in the loop's body, their split into pipes
(``alu``: integer adds, logic, shifts, compares, selects, permutes; ``fma``:
``IMAD*`` and float multiply-adds; ``mufu``; ``conv``; ``mem``; ``ctrl``;
``uniform``), its global stores and so the elements an iteration writes,
and the instructions an element.  A static count: a path inside the loop
that the data never takes is counted too.

With ``--train`` it runs, for each source, that tree's own
``chip_smoke.train_path`` instead (6 fused W-Icon commits of one full-width
qwen3-4b chain) and prints its ms per commit, and with ``--cluster`` that
tree's ``chip_smoke.cluster_path`` (phase 8c: 3 fused W-Icon commits of 4
chains of qwen3-4b at 4 layers; run twice, the first a warm-up):
host-bound numbers, so compare trees only in turns within one call.

With ``--chains`` it times instead, at C 4 chains on the 4-layer stacked
leaf (4 x 2560 x 9728 bf16 a chain, ``chip_smoke.STACK4_LEAF``; maxvals
3, 3, 2, 1 as ``chip_smoke.py`` phase 2 times them), the update and the
one-pass read; and, for a tree whose update takes a skip word and a flag
output, the update writing the non-finite flags (the ``health_check``
path) and the update with one chain skipped.

Prints the card's name, power limit and SM clock, then one JSON object a
line.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SMS, LANES = 132, 128  # H100 SXM: SMs, and 4 schedulers x 32 lanes each
PARAM_ELEMENTS = 4_410_000_000  # qwen3-4b's 4.41 B parameters, one chain
SMI_QUERY = "name,power.limit,clocks.sm,clocks.max.sm"


def smi() -> list:
    return subprocess.run(["nvidia-smi", f"--query-gpu={SMI_QUERY}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0].split(", ")


def max_sm_hz() -> float:
    return float(smi()[3].split()[0]) * 1e6


# ---------------------------------------------------------------------------
# SASS
# ---------------------------------------------------------------------------
_INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_PIPES = (("alu", ("IADD3", "LOP3", "SHF", "ISETP", "SEL", "PRMT", "LEA", "IMNMX",
                   "IABS", "FSEL", "FSETP", "FMNMX", "PLOP3", "P2R", "R2P", "FLO",
                   "POPC", "BMSK", "MOV", "SHL", "SHR", "LOP", "IADD", "VIADD")),
          ("fma", ("IMAD", "FFMA", "FMUL", "FADD", "HFMA2", "HMUL2", "HADD2", "DFMA")),
          ("mufu", ("MUFU",)),
          ("conv", ("F2F", "F2I", "I2F", "F2FP", "I2FP", "FRND")),
          ("mem", ("LDG", "STG", "LDS", "STS", "LDL", "STL", "LDC", "LD", "ST",
                   "RED", "ATOM", "ATOMG")),
          ("ctrl", ("BRA", "EXIT", "BSSY", "BSYNC", "NOP", "CALL", "RET",
                    "WARPSYNC", "YIELD", "BREAK", "BAR", "JMP")))
_STORE_BYTES = {"128": 16, "64": 8, "U16": 2, "S16": 2, "U8": 1, "S8": 1}


def pipe_of(op: str) -> str:
    base = op.split(".")[0]
    if base.startswith("U") or base in ("R2UR", "S2UR"):
        return "uniform"  # the warp-wide scalar datapath
    for pipe, bases in _PIPES:
        if base in bases:
            return pipe
    return "other"


def store_bytes(op: str) -> int:
    parts = op.split(".")
    for p in parts[1:]:
        if p in _STORE_BYTES:
            return _STORE_BYTES[p]
    return 4


def elem_bytes(kernel: str) -> int:
    return 2 if ("13__nv_bfloat16" in kernel or re.search(r"kernelIt", kernel)) else 4


def sass_report(lib: Path) -> list:
    """Each kernel of ``lib``: its instructions, and each loop's body."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out = []
    for chunk in text.split("Function : ")[1:]:
        name = chunk.split()[0]
        code = []
        for line in chunk.splitlines():
            m = _INSTR.match(line)
            if m:
                instr = re.sub(r"^@!?U?P\w+\s+", "", m.group(2))
                code.append((int(m.group(1), 16), instr))
        addr = {a: k for k, (a, _) in enumerate(code)}
        loops = []
        for k, (a, ins) in enumerate(code):
            m = re.match(r"BRA(?:\.\S+)?\s+(?:.*?)(0x[0-9a-f]+)", ins)
            if not m:
                continue
            target = int(m.group(1), 16)
            if target >= a or target not in addr:
                continue  # forward, or the branch-to-self after EXIT
            body = [i for _, i in code[addr[target]:k + 1]]
            ops = [i.split()[0] for i in body]
            pipes = {}
            for op in ops:
                pipes[pipe_of(op)] = pipes.get(pipe_of(op), 0) + 1
            stores = [op for op in ops if op.startswith("STG")]
            written = sum(store_bytes(op) for op in stores)
            per_iter = written / elem_bytes(name) if written else None
            loops.append({"from": hex(target), "to": hex(a), "instructions": len(body),
                          "pipes": pipes, "stores": stores,
                          "elements_per_iteration": per_iter,
                          "instructions_per_element":
                              len(body) / per_iter if per_iter else None})
        out.append({"kernel": name, "instructions": len(code), "loops": loops})
    return out


# ---------------------------------------------------------------------------
# one tree
# ---------------------------------------------------------------------------
def run_one(src: str, iters: int, sass: bool) -> None:
    import numpy as np
    import torch

    sys.path.insert(0, src)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import delay_gather as dg
    from repro_torch.kernels import langevin_update as lu

    build.build(["delay_gather", "langevin_update"])
    if sass:
        for name in ("delay_gather", "langevin_update"):
            for rep in sass_report(build._lib_path(name)):
                print(json.dumps({"src": src, "source": name, **rep}), flush=True)
    n, depth, head, key = cs.LARGEST_LEAF, 3, 2, (0xC0FFEE, 9)
    hz = max_sm_hz()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.randn(n, generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
    g = (torch.randn(n, generator=gen, device="cuda") * 1e-2).to(torch.bfloat16)
    hist = torch.randn(depth, n, generator=gen, device="cuda").to(torch.bfloat16)
    seed, gamma = (0x1234ABCD, 77), np.float32(1e-3)
    scale = np.sqrt(np.float32(2.0 * 1e-5) * gamma)
    if _per_chain_heads(lu):
        # kernels over a chain axis with a head a chain: C = 1, tables once
        x1, g1, hist1 = x[None], g[None], hist[None]
        ut = _table(lu.chain_rows([seed], [gamma], [scale]))
        dt = {m: _table(dg.randint_rows([key], [m], [head])) for m in (2, depth)}
        delays = dg.coordinate_delays(dt[depth], n, [depth])

        def update():
            return lu.langevin_update(x1, g1, ut)

        def draw():
            return dg.coordinate_delays(dt[depth], n, [depth])

        def gather():
            return dg.delay_gather(hist1, delays, [head])

        def read(maxval=depth):
            return dg.wicon_read(hist1, dt[maxval], [maxval], [head])
        kernels = 1
    elif len(inspect.signature(lu.langevin_update).parameters) == 3:
        # kernels over a chain axis under one shared head: C = 1, tables once
        x1, g1, hist1 = x[None], g[None], hist[None]
        ut = _table(lu.chain_rows([seed], [gamma], [scale]))
        dt = {m: _table(dg.randint_rows([key], [m])) for m in (2, depth)}
        delays = dg.coordinate_delays(dt[depth], n, [depth])

        def update():
            return lu.langevin_update(x1, g1, ut)

        def draw():
            return dg.coordinate_delays(dt[depth], n, [depth])

        def gather():
            return dg.delay_gather(hist1, delays, head)

        def read(maxval=depth):
            return dg.wicon_read(hist1, dt[maxval], [maxval], head)
        kernels = 1
    else:
        delays = dg.coordinate_delays(key, n, depth, "cuda")

        def update():
            return lu.langevin_update(x, g, seed, gamma, scale)

        def draw():
            return dg.coordinate_delays(key, n, depth, "cuda")

        def gather():
            return dg.delay_gather(hist, delays, head)

        if hasattr(dg, "wicon_read"):
            def read(maxval=depth):
                return dg.wicon_read(hist, key, maxval, head)
            kernels = 1
        else:
            def read(maxval=depth):
                return dg.delay_gather(hist, dg.coordinate_delays(key, n, maxval, "cuda"),
                                       head)
            kernels = 2
    cases = {
        "langevin_update": (update, 3 * 2 * n, cs.LANGEVIN_OPS * n),
        "coordinate_delays": (draw, 4 * n, cs.DELAY_OPS * n),
        "delay_gather": (gather, n * (4 + 2 + 2), 4 * n),
        "wicon_read": (read, n * (2 + 2), cs.DELAY_OPS * n),
        # maxval 2 (a commit one step stale): 2^32 mod 2 = 0, one bit
        # stream of the two drops out of randint's sum
        "wicon_read_maxval_2": (lambda: read(2), n * (2 + 2),
                                (cs.THREEFRY_OPS + 4) * n),
    }
    for name, (fn, nbytes, ops) in cases.items():
        ms = cs.cuda_ms(torch, [fn], iters)
        bound_ms, bound_by = cs.bound(nbytes, ops, cs.ALU_OPS)
        res = {"src": src, "kernel": name, "n": n, "ms": ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "share_of_bound": bound_ms / ms,
               "issue_slots_per_element": ms * 1e-3 * SMS * LANES * hz / n}
        if name.startswith("wicon_read"):
            res["kernels"] = kernels
        print(json.dumps(res), flush=True)
    # one call at a time: after a synchronise, and after a parameter-size copy
    src_buf = torch.empty(PARAM_ELEMENTS, dtype=torch.bfloat16, device="cuda")
    dst_buf = torch.empty_like(src_buf)
    for name in ("delay_gather", "wicon_read"):
        fn = cases[name][0]
        single, after = [], []
        for _ in range(max(3, iters // 4)):
            for times, copy in ((single, False), (after, True)):
                torch.cuda.synchronize()
                if copy:
                    dst_buf.copy_(src_buf)
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                fn()
                e1.record()
                e1.synchronize()
                times.append(e0.elapsed_time(e1))
        print(json.dumps({"src": src, "kernel": name, "single_ms": sum(single) / len(single),
                          "after_copy_ms": sum(after) / len(after),
                          "calls": len(single)}), flush=True)


def _table(rows):
    import numpy as np
    import torch

    return torch.from_numpy(np.ascontiguousarray(rows).view(np.int32)).to("cuda")


def _per_chain_heads(lu) -> bool:
    """The tree's kernels take a head a chain (and the update a skip word
    and a flag output)."""
    return "flags" in inspect.signature(lu.langevin_update).parameters


def run_chains(src: str, iters: int) -> None:
    """The update and the one-pass read at C 4 on the 4-layer stacked
    leaf, as ``chip_smoke.py`` phase 2 times them (PERF.md rows 3c, 4c)."""
    import numpy as np
    import torch

    sys.path.insert(0, src)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build, rng
    from repro_torch.kernels import delay_gather as dg
    from repro_torch.kernels import langevin_update as lu

    build.build(["delay_gather", "langevin_update"])
    C, n, maxvals, head = 4, cs.STACK4_LEAF, [3, 3, 2, 1], 2
    gen = torch.Generator(device="cuda").manual_seed(0)
    seeds = rng.split((n, C), C)
    gammas = np.full(C, 1e-3, np.float32)
    scales = np.full(C, np.sqrt(np.float32(2e-5) * np.float32(1e-3)), np.float32)
    x = (torch.randn(C, n, generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
    g = (torch.randn(C, n, generator=gen, device="cuda") * 1e-2).to(torch.bfloat16)
    new = _per_chain_heads(lu)
    ut = _table(lu.chain_rows(seeds, gammas, scales))
    cases = {"update": lambda: lu.langevin_update(x, g, ut)}
    if new:
        flags = torch.zeros(C, dtype=torch.int32, device="cuda")
        skip_t = _table(lu.chain_rows(seeds, gammas, scales, [False, True, False, False]))
        cases["update_flags"] = lambda: lu.langevin_update(x, g, ut, flags)
        cases["update_one_skipped"] = lambda: lu.langevin_update(x, g, skip_t)
    res = {"src": src, "chains": C, "n": n}
    for name, fn in cases.items():
        res[f"{name}_ms"] = cs.cuda_ms(torch, [fn], iters)
    del x, g
    torch.cuda.empty_cache()
    h = torch.randn(C, 3, n, generator=gen, device="cuda").to(torch.bfloat16)
    keys = rng.split((C, n + 1), C)
    if new:
        heads = [head] * C
        rt = _table(dg.randint_rows(keys, maxvals, heads))
        res["read_ms"] = cs.cuda_ms(torch, [lambda: dg.wicon_read(h, rt, maxvals, heads)],
                                    iters)
        mixed = [2, 1, 2, 0]  # heads parted by masked commits
        mt = _table(dg.randint_rows(keys, maxvals, mixed))
        res["read_mixed_heads_ms"] = cs.cuda_ms(
            torch, [lambda: dg.wicon_read(h, mt, maxvals, mixed)], iters)
    else:
        rt = _table(dg.randint_rows(keys, maxvals))
        res["read_ms"] = cs.cuda_ms(torch, [lambda: dg.wicon_read(h, rt, maxvals, head)],
                                    iters)
    print(json.dumps(res), flush=True)


def run_path(src: str, which: str) -> None:
    """The tree's own ``chip_smoke.train_path`` or ``cluster_path``."""
    import numpy as np
    import torch

    sys.path.insert(0, src)
    spec = importlib.util.spec_from_file_location(
        "tree_chip_smoke", Path(src).parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from repro_torch.kernels import delay_gather as dg
    from repro_torch.kernels import langevin_update as lu

    torch.backends.cuda.matmul.allow_tf32 = False
    if which == "cluster":
        import gc

        kernels = {"langevin_update": lu.langevin_update, "wicon_read": dg.wicon_read,
                   "delay_gather": dg.delay_gather,
                   "coordinate_delays": dg.coordinate_delays}
        for run in ("warm-up", "timed"):  # the first run pays the process's set-up
            out = cs.cluster_path(torch, np, kernels)
            print(json.dumps({"src": src, "path": "cluster", "run": run,
                              "ms_per_commit": out["ms_per_commit"],
                              "wall_s": out["wall_s"], "peak_gb": out["peak_gb"]}),
                  flush=True)
            del out
            gc.collect()
            torch.cuda.empty_cache()
        return
    run_train(src, cs)


def run_train(src: str, cs) -> None:
    import numpy as np
    import torch
    from repro_torch.kernels import delay_gather as dg
    from repro_torch.kernels import langevin_update as lu

    out = cs.train_path(torch, np, lu, dg)
    print(json.dumps({"src": src, "ms_per_commit": out["ms_per_commit"],
                      "tokens_per_s": out["tokens_per_s"],
                      "first_chunk_s": out["first_chunk_s"], "peak_gb": out["peak_gb"],
                      "launches": out["launches"]}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append",
                    help="a src directory holding repro_torch (repeatable)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--sass", action="store_true",
                    help="also count each kernel's SASS instructions")
    ap.add_argument("--train", action="store_true",
                    help="time each tree's chip_smoke.train_path instead")
    ap.add_argument("--cluster", action="store_true",
                    help="time each tree's chip_smoke.cluster_path instead")
    ap.add_argument("--chains", action="store_true",
                    help="time the update and the read at C 4 on the 4-layer leaf")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one and (args.train or args.cluster):
        run_path(args.one, "cluster" if args.cluster else "train")
        return 0
    if args.one and args.chains:
        run_chains(args.one, args.iters)
        return 0
    if args.one:
        run_one(args.one, args.iters, args.sass)
        return 0
    print(", ".join(smi()), flush=True)
    for src in args.src or [str(ROOT / "src")]:
        subprocess.run([sys.executable, __file__, "--one", str(Path(src).resolve()),
                        "--iters", str(args.iters)]
                       + (["--sass"] if args.sass else [])
                       + (["--train"] if args.train else [])
                       + (["--cluster"] if args.cluster else [])
                       + (["--chains"] if args.chains else []), check=True)
    print(", ".join(smi()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
