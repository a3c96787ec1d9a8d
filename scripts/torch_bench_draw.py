#!/usr/bin/env python3
"""Time the port's two draw kernels (``jax_draw``, ``categorical``) on one
NVIDIA GPU, for one or more copies of the package.

    python3 scripts/torch_bench_draw.py [--src DIR ...] [--sass] [--quick] [--phases | --bank]

Each ``--src`` is a ``src`` directory holding ``repro_torch`` (default: this
checkout's).  Giving two, e.g. an unpacked parent commit's and this one's,
as ``--src A --src B --src B --src A`` times them in turns in one call on
one card, so they can be compared.  Each source runs in its own
subprocess, so that its kernels are built from its own ``csrc/``.

The cases are ``chip_smoke.py``'s phase 2 (this checkout's, the same for
every tree): ``DRAW_CASES`` (a ragged normal, 2^20, the largest leaf's std
* normal into bf16, a 4-D block, 2^20 straddling 2^32, uniform and gumbel
at (8, 4,099), an f32 normal and an f32 gumbel of 2^27), the 36-row key
table, and the categorical at ``CATEGORICAL_CASES`` ((4 and 8, 151,936)
bf16 and f32 under one key and a key a row, a V that 8 does not divide, a
row offset that breaks 16-byte alignment).  For each it prints:

- ``graph_ms``: the kernel's device time, from CUDA-graph replays of
  ``iters`` calls, replayed until the window passes 300 ms
  (``chip_smoke.graph_clock_ms``), with ``nvidia-smi``'s ``clocks.sm``,
  ``power.draw`` and ``power.limit`` read while the window runs;
- ``call_ms``: back-to-back calls timed by CUDA events, the wrapper's host
  enqueue inside the window (``chip_smoke.cuda_ms``);
- the bounds: ``chip_smoke.py``'s (operations at ``ALU_OPS``, or bytes),
  and with ``--sass`` the per-pipe bound from the tree's own SASS counts
  (the larger of its bytes over HBM, its integer instructions at 64 a
  clock an SM, all its instructions at 128 and its conversions and MUFU
  at 16, at the clock read in the window).

Then each wrapper's host enqueue alone, in microseconds a call: 2,000 calls
timed by the host clock with no synchronise between them (a 1,024-element
normal; a (4, 151,936) bf16 categorical), after a warm-up.

``--sass`` also prints the ``-Xptxas=-v`` lines (registers, spills) of
both sources, compiled on their own, and the instruction counts of the
kernels' element loops from ``cuobjdump -sass`` of the built libraries:
per element, by kind — integer ALU (adds, logic, shifts, compares and
selects), integer multiply-adds (``IMAD``: the compiler also moves and
adds through them), float FMA (``FFMA``, ``FMUL``, ``FADD``), conversion
and MUFU, branch, and the rest (memory, moves).  The integer bound counts
both integer kinds at 64 a clock, as the CUDA programming guide's
throughput table gives them for compute capability 9.0.
A static count of the pass that handles ``kPer`` elements (``kCols``
columns): the loop's or the kernel's instructions less its inner loops'
(a ragged end), over the elements; a branch the data rarely takes (the
normal's ``w >= 5``, a division's slow path) is counted as if always
taken, and both sides of ``log1p``'s branch are counted, as a warp whose
lanes take both runs both.  ``--quick`` times only the largest leaf, the
4-D block and the (4, 151,936) categoricals.

With ``--phases`` it runs instead, for each source, that tree's own
``chip_smoke.py`` (the one beside its ``src``): phase 2's draw checks and
``init_params`` check, and phase 8's serve quickstart (``serve_quickstart``),
each with its wall seconds: host-bound numbers, so compare trees only in
turns within one call.  With ``--bank``: that tree's full-width qwen3-4b
bank of 4 chains from a key (``init_params``, twice) and the default
unfused noise over one chain (``noise_like``, three times after the
first), wall seconds around a synchronise, as ``chip_smoke.py`` phase 4
times them.

Prints the card's name, power limit and SM clock, then one JSON object a
line.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SMS = 132  # H100 SXM
INT_LANES, ALL_LANES, CONV_LANES = 64, 128, 16  # a clock an SM (sm_90)

_INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_KINDS = (("int", ("IADD3", "LOP3", "SHF", "ISETP", "SEL", "PRMT", "LEA", "IMNMX",
                   "IABS", "POPC", "FLO", "BMSK", "SHL", "SHR", "IADD", "VIADD",
                   "FSETP", "FSEL", "FMNMX", "PLOP3", "P2R", "R2P", "LOP")),
          ("imad", ("IMAD", "IMUL")),
          ("fma", ("FFMA", "FMUL", "FADD")),
          ("conv_mufu", ("F2F", "F2I", "I2F", "F2FP", "I2FP", "FRND", "MUFU")),
          ("branch", ("BRA", "BSSY", "BSYNC", "EXIT", "CALL", "RET", "WARPSYNC", "BREAK",
                      "JMP")))


def smi(query="name,power.limit,clocks.sm,clocks.max.sm") -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def kind_of(op: str) -> str:
    base = op.split(".")[0]
    for kind, bases in _KINDS:
        if base in bases:
            return kind
    return "other"


def _body(code, lo: int, hi: int, loops) -> list:
    """The instructions of code[lo:hi] outside the loops nested in it."""
    inner = [(a, b) for a, b in loops if lo <= a and b <= hi and (a, b) != (lo, hi)]
    return [ins for k, (_, ins) in enumerate(code[lo:hi], lo)
            if not any(a <= k < b for a, b in inner)]


def sass_counts(lib: Path, pattern: str, per: int, loop: bool) -> list:
    """Each kernel of ``lib`` whose name matches ``pattern``: the
    instructions a pass takes (its outermost loop's body when ``loop``,
    else the kernel's), less its inner loops', per element (``per``
    elements a pass), by kind."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out = []
    for chunk in text.split("Function : ")[1:]:
        name = chunk.split()[0]
        if not re.search(pattern, name):
            continue
        code = []
        for line in chunk.splitlines():
            m = _INSTR.match(line)
            if m:
                code.append((int(m.group(1), 16), re.sub(r"^@!?U?P\w+\s+", "", m.group(2))))
        addr = {a: k for k, (a, _) in enumerate(code)}
        loops = []
        for k, (a, ins) in enumerate(code):
            m = re.match(r"BRA(?:\.\S+)?\s+(?:.*?)(0x[0-9a-f]+)", ins)
            if m and int(m.group(1), 16) < a and int(m.group(1), 16) in addr:
                loops.append((addr[int(m.group(1), 16)], k + 1))
        if loop and loops:
            lo, hi = max(loops, key=lambda ab: ab[1] - ab[0])
        else:
            lo, hi = 0, len(code)
        body = _body(code, lo, hi, loops)
        kinds = {}
        for ins in body:
            kinds[kind_of(ins.split()[0])] = kinds.get(kind_of(ins.split()[0]), 0) + 1
        out.append({"kernel": name, "instructions": len(code), "pass": len(body),
                    "elements_a_pass": per,
                    "per_element": {k: v / per for k, v in sorted(kinds.items())},
                    "per_element_total": len(body) / per})
    return out


def ptxas(src: Path) -> list:
    """``-Xptxas=-v``'s register and spill lines of both sources, each
    compiled on its own (all at once)."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    tmp = Path(tempfile.mkdtemp(prefix="ptxas_"))
    csrc = src / "repro_torch" / "kernels" / "csrc"
    procs = {name: subprocess.Popen(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-cubin",
         "-Xptxas=-v", "-o", str(tmp / f"{name}.cubin"), str(csrc / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in ("jax_draw", "categorical")}
    lines = []
    for name, p in procs.items():
        log = p.communicate()[0]
        entry = None
        for line in log.splitlines():
            if "Compiling entry" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "registers" in line or "spill" in line:
                lines.append({"source": name, "entry": entry, "line": line.strip()})
    shutil.rmtree(tmp, ignore_errors=True)
    return lines


def _per(src: Path, name: str, const: str):
    """The tree's ``constexpr int const`` of ``csrc/name.cu``, or None."""
    text = (src / "repro_torch" / "kernels" / "csrc" / f"{name}.cu").read_text()
    m = re.search(rf"constexpr int {const} = (\d+)", text)
    return int(m.group(1)) if m else None


def enqueue_us(torch, fn, calls: int = 2000) -> float:
    """Host microseconds a call, no synchronise between calls."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def run_one(src: str, sass: bool, quick: bool) -> None:
    import numpy as np
    import torch

    sys.path.insert(0, src)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import categorical as kc
    from repro_torch.kernels import jax_draw as jd
    from repro_torch.kernels import rng

    t0 = time.perf_counter()
    build.build(["jax_draw", "categorical"])
    print(json.dumps({"src": src, "built_s": time.perf_counter() - t0}), flush=True)
    per_sass = {}
    if sass:
        for line in ptxas(Path(src)):
            print(json.dumps({"src": src, "ptxas": line}), flush=True)
        # a pass: the draw's loop body (kPer elements); the categorical's
        # kernel (kCols columns), or the parent's loop body (a column)
        ccols = _per(Path(src), "categorical", "kCols")
        for rep in sass_counts(build._lib_path("jax_draw"),
                               r"jax_draw_kernelILi[12]E(Lb0E)?Li[01]E(jE|EEv)",
                               _per(Path(src), "jax_draw", "kPer"), True):
            print(json.dumps({"src": src, "sass": rep}), flush=True)
            per_sass[rep["kernel"]] = rep
        for rep in sass_counts(build._lib_path("categorical"),
                               r"categorical_kernelILi[01]E(jE|EEv)", ccols or 1,
                               ccols is None):
            print(json.dumps({"src": src, "sass": rep}), flush=True)
            per_sass[rep["kernel"]] = rep
    dev = torch.device("cuda")
    key = rng.PRNGKey(7)

    def sass_bound(kernel_re: str, n: int, nbytes: int, clock_mhz: float):
        rep = next((r for k, r in per_sass.items() if re.search(kernel_re, k)), None)
        if rep is None:
            return None
        pe, hz = rep["per_element"], clock_mhz * 1e6
        times = {"bytes": nbytes / cs.HBM_BYTES_PER_S * 1e3,
                 "int": n * (pe.get("int", 0) + pe.get("imad", 0))
                 / (INT_LANES * SMS * hz) * 1e3,
                 "all": n * rep["per_element_total"] / (ALL_LANES * SMS * hz) * 1e3,
                 "conv_mufu": n * pe.get("conv_mufu", 0) / (CONV_LANES * SMS * hz) * 1e3}
        by = max(times, key=times.get)
        return {"ms": times[by], "by": by, "times": times}

    value_idx = {"uniform": 0, "normal": 1, "gumbel": 2}
    dtype_idx = {"float32": 0, "bfloat16": 1, "float16": 2}
    cases = [c for c in cs.DRAW_CASES if not quick or c[0] in ("largest_leaf", "block_4d")]
    for name, shape, start, block, value, scale, dt in cases:
        dtype = getattr(torch, dt)
        parts = rng._block_of(shape, block)
        n = math.prod(length for _, length in parts)
        op = None if scale is None else "mul"

        def kernel(shape=shape, parts=parts, value=value, start=start, op=op, scale=scale,
                   dtype=dtype):
            return jd.jax_draw(key, shape, parts, value, dev, start=start, op=op,
                               c=scale or 1.0, lo=-2.0, span=5.0, dtype=dtype)

        iters = 3 if n > 2**26 else 20
        gms, clock = cs.graph_clock_ms(torch, [kernel], iters)
        call = cs.cuda_ms(torch, [kernel], iters)
        nbytes = n * dtype.itemsize
        ops = {"normal": cs.NORMAL_OPS, "gumbel": cs.GUMBEL_OPS, "uniform": cs.UNIFORM_OPS}
        bms, by = cs.bound(nbytes, n * (ops[value] + (op is not None) + (dt != "float32")),
                           cs.ALU_OPS)
        wide = start + math.prod(shape) > 2**32
        kre = rf"jax_draw_kernelILi{value_idx[value]}E(Lb0E)?Li{dtype_idx[dt]}E" + (
            "yE" if wide else "(jE|EEv)")
        print(json.dumps({"src": src, "case": name, "elements": n, "dtype": dt,
                          "graph_ms": gms, "call_ms": call, "smi": clock,
                          "bound_ms": bms, "bound_by": by,
                          "sass_bound": sass_bound(kre, n, nbytes,
                                                   clock["clocks.sm"])}), flush=True)
        torch.cuda.empty_cache()
    if not quick:
        keys = torch.tensor(rng.split(rng.PRNGKey(3), 36), dtype=torch.int64)
        table = rng._key_words(keys, dev)

        def rows():
            return jd.jax_draw_rows(table, 256 * 1024, "normal", op="mul", c=1 / 16,
                                    dtype=torch.bfloat16)

        n = 36 * 256 * 1024
        gms, clock = cs.graph_clock_ms(torch, [rows], 20)
        bms, by = cs.bound(2 * n, n * (cs.NORMAL_OPS + 2), cs.ALU_OPS)
        print(json.dumps({"src": src, "case": "key_table_36", "elements": n,
                          "dtype": "bfloat16", "graph_ms": gms,
                          "call_ms": cs.cuda_ms(torch, [rows], 20), "smi": clock,
                          "bound_ms": bms, "bound_by": by,
                          "sass_bound": sass_bound(r"jax_draw_kernelILi1E(Lb0E)?Li1E(jE|EEv)", n,
                                                   2 * n, clock["clocks.sm"])}), flush=True)
    for B, V, dt, mode, offset in cs.CATEGORICAL_CASES:
        if quick and (B, V, mode, offset) != (4, cs.VOCAB, "key", 0):
            continue
        dtype = getattr(torch, dt)
        logp = cs.categorical_logp(torch, B, V, dtype, offset)
        slot_keys = rng.fold_in_rows(np.asarray(rng.split(key, B), np.int64),
                                     np.arange(B)).to(dev)
        if mode == "key":
            def draw(logp=logp):
                return rng.categorical(key, logp)
        else:
            def draw(logp=logp, slot_keys=slot_keys):
                return rng.categorical_rows(slot_keys, logp)
        gms, clock = cs.graph_clock_ms(torch, [draw], 50)
        call = cs.cuda_ms(torch, [draw], 50)
        n = B * V
        nbytes = n * logp.element_size() + 8 * B
        bms, by = cs.bound(nbytes, n * cs.CATEGORICAL_OPS, cs.ALU_OPS)
        print(json.dumps({"src": src, "case": "categorical", "rows": B, "V": V, "dtype": dt,
                          "mode": mode, "offset": offset, "graph_ms": gms, "call_ms": call,
                          "smi": clock, "bound_ms": bms, "bound_by": by,
                          "sass_bound": sass_bound(
                              rf"categorical_kernelILi{dtype_idx[dt]}E(jE|EEv)", n, nbytes,
                              clock["clocks.sm"])}), flush=True)
    small = {"draw": lambda: jd.jax_draw(key, (1024,), [(0, 1024)], "normal", dev)}
    logp = cs.categorical_logp(torch, 4, cs.VOCAB, torch.bfloat16, 0)
    small["categorical"] = lambda: kc.categorical(logp, key=key)
    for name, fn in small.items():
        print(json.dumps({"src": src, "enqueue_us": name, "us": enqueue_us(torch, fn)}),
              flush=True)


def run_phases(src: str) -> None:
    """The tree's own ``chip_smoke.py`` (beside its ``src``): phase 2's draw
    checks (``run_draw_checks`` and ``init_reference_check``) and phase 8's
    serve quickstart, each with its wall seconds."""
    import numpy as np
    import torch

    sys.path[:0] = [src, str(Path(src).parent)]
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_step as ds
    from repro_torch.kernels import delay_gather as dg
    from repro_torch.kernels import langevin_update as lu

    build.build(["jax_draw", "categorical"])
    kernels = {"langevin_update": lu.langevin_update, "wicon_read": dg.wicon_read,
               "delay_gather": dg.delay_gather, "coordinate_delays": dg.coordinate_delays}
    t0 = time.perf_counter()
    draws = cs.run_draw_checks(torch, np)
    cs.init_reference_check(torch, np)
    phase2_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sq = cs.serve_quickstart(torch, np, kernels, ds)
    print(json.dumps({"src": src, "phase2_draws_s": phase2_s,
                      "serve_quickstart_s": time.perf_counter() - t0, "serve_quickstart": sq,
                      "draws": draws}), flush=True)


def run_bank(src: str) -> None:
    """The tree's full-width qwen3-4b bank of 4 chains drawn from a key
    (``init_params``, one draw launch a leaf, a key a row), twice, and the
    default unfused noise over one chain (``noise_like``, 14 launches),
    after a warm-up, each in wall seconds around a synchronise."""
    import torch

    sys.path.insert(0, src)
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.kernels import rng
    from repro_torch.models.transformer import init_params
    from repro_torch.samplers.transform import chain_at
    from repro_torch.samplers.transforms import langevin_scale, noise_like
    from repro_torch.utils import tree_leaves

    build.build(["jax_draw"])
    cfg, init_s = get_arch("qwen3-4b"), []
    for _ in range(2):
        params = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = init_params(cfg, 0, device="cuda", num_chains=4)
        torch.cuda.synchronize()
        init_s.append(time.perf_counter() - t0)
    chain, scale = chain_at(params, 0), langevin_scale(1e-6, 1e-3)
    noise_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        noise = tree_leaves(noise_like(rng.PRNGKey(9), chain, scale, torch.float32))
        torch.cuda.synchronize()
        noise_ms.append((time.perf_counter() - t0) * 1e3)
        del noise
    print(json.dumps({"src": src, "bank_init_s": init_s, "chain_noise_ms": noise_ms,
                      "smi": smi()}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append",
                    help="a src directory holding repro_torch (repeatable)")
    ap.add_argument("--sass", action="store_true",
                    help="also count the kernels' SASS and print -Xptxas=-v")
    ap.add_argument("--quick", action="store_true",
                    help="the largest leaf, the 4-D block and (4, V) categoricals only")
    ap.add_argument("--phases", action="store_true",
                    help="run each tree's own chip_smoke phase-2 draw checks and serve "
                         "quickstart instead")
    ap.add_argument("--bank", action="store_true",
                    help="time each tree's 4-chain qwen3-4b init_params and a chain's "
                         "default noise instead")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one and args.bank:
        run_bank(args.one)
        return 0
    if args.one and args.phases:
        run_phases(args.one)
        return 0
    if args.one:
        run_one(args.one, args.sass, args.quick)
        return 0
    print(smi(), flush=True)
    for src in args.src or [str(ROOT / "src")]:
        subprocess.run([sys.executable, __file__, "--one", str(Path(src).resolve())]
                       + (["--sass"] if args.sass else [])
                       + (["--quick"] if args.quick else [])
                       + (["--phases"] if args.phases else [])
                       + (["--bank"] if args.bank else []), check=True)
    print(smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
