#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It imports only ``repro_torch`` (plus torch, numpy and the standard
library) and runs, failing on the first phase that fails:

1. the card's name and power limit (``nvidia-smi``), then the build of every
   CUDA kernel from ``src/repro_torch/kernels/csrc`` with ``nvcc`` (one
   process per source, all at once);
2. each split-KV decode kernel against its plain PyTorch version on the
   card, at the main path's shapes (qwen3-4b: 8 KV heads, 4 query heads
   per KV head, head_dim 128; 4 chains) and at long contexts (a full
   1024-slot and a 16,384-slot ring; paged windows of 4,096 positions), in
   bf16 and float32: outputs within the stated tolerance (in bf16 also
   within two bf16 ulps of each row's largest plain output, which a ring
   missing one split's positions exceeds) and bitwise equal across two
   calls, caches / pools bit-for-bit equal outside the garbage
   row; with the kernel's, the plain version's and one PyTorch library
   call's time (``scaled_dot_product_attention``), and the bytes bound;
   then both at a group of 3 (12 query heads over 4 KV heads, head_dim 64:
   the 110M example model) on the decode cell's ring and the paged cell, in
   bf16 and float32, timed, and likewise at the model zoo's shapes
   (kimi-k2's head_dim 112 at a group of 8, stablelm-12b's 160 at 4,
   internvl2-1b's group of 7 at head_dim 64, hymba-1.5b's group of 5 at
   head_dim 64, the ring kernel at G 5 also on the rings hymba's serving
   gives it: 16 rows of 48 slots, one row of 1,024); then the SGLD kernels (Langevin update, delay draw, delay gather, the
   one-pass W-Icon read) against theirs, at a ragged length (misaligned
   rows, the scalar code) and at 2^20 elements (the vector code) in bf16,
   float32 and int32, over rings of depth 1-5, and at the largest
   full-width leaf (36 x 2560 x 9728 bf16): the update within 2e-6 in
   float32 and one bf16 ulp in bf16, its noise alone (gamma 0, x 0)
   likewise, the delays, the gather (out-of-range delays included) and the
   read bit for bit (each kernel takes chains on a leading axis; these
   cases are one chain, C = 1); with times and bounds (``torch.gather`` is
   the gather's library call); then the update, the one-pass read, the
   draw and the gather on C chains in one launch (each chain under its own
   key, gamma, scale and maxval) against their plain versions and against
   the same kernels on each chain alone: C 32 on a
   5-element and a ragged leaf (rows off 16 bytes), C 4 on the 4-layer
   stacked largest leaf (4 x 2560 x 9728) and the embedding (151936 x
   2560), bf16, timed there (the chains' ring heads differ in the C 32
   cases: each kernel takes chain c's head from chain c's row); then the
   masked commit: the update with chains skipped (their NaN gradient rows
   never read) bitwise untouched there and bitwise the unmasked kernel
   elsewhere, its non-finite flags equal to ``torch.isfinite`` of the
   output and to the plain version's, and the read over a head a chain,
   on a ragged leaf and the stacked leaf, timed with the flags written and
   with one chain skipped;
3. the engines on a reduced float32 bank, on the card (kernels) and on the
   CPU (plain path): the same tokens and BMA log-probs within 1e-4; then
   4 fused W-Icon training commits of the reduced float32 model on both:
   losses within rtol 1e-5, parameters within 1e-5;
4. the main path, part 1: ``DecodeEngine`` over a 4-chain bank of
   full-width qwen3-4b (36 layers, bf16, ~35 GB of weights drawn on the
   card from a seeded ``torch.Generator``): 4 prompts x 32 tokens, 16 new
   tokens greedy, then one sampled request; the decode kernel must have run
   once per layer per decode step;
5. the main path, part 2: ``PagedDecodeEngine`` on the same bank — 8 slots,
   page size 16, max_seq 256, 12 requests of mixed lengths, two of them at
   a higher priority that preempts; the paged kernel must have run once
   per layer per micro-step, and every page must be free at the end; then
   ``ServeEngine`` on the same bank: (a) ``transformer_next_token_predict``
   over 8 prompts of 1,024 tokens (``Model.prefill``, the long-prompt SDPA
   path): the mean within rtol 1e-6 of the chain average of the per-chain
   predictions, ordered quantiles, finite, with ms a request, queries/s
   and peak memory; (b) a mixed stream of 3, 5, 8 and 3 queries of 128
   tokens, whose host pad scratch stops growing once rungs 4 and 8 have
   been seen; (c) one 8,192-token query, with its peak memory; no decode
   kernel runs in (a)-(c); (d) ``ServeEngine.decoder`` greedy-decodes
   the ``DecodeEngine`` section's tokens (the ring kernel once per layer
   per step);
6. the main path, part 3, once the serving bank is freed: delayed-gradient
   SGLD training of one full-width qwen3-4b chain (4.4 B parameters, bf16,
   drawn on the card) through the launcher's path
   (``repro_torch.launch.train``: ``--mode inconsistent --fused --tau 2
   --batch 8 --seq 128``), 6 commits in chunks of 3, delays from 8
   simulated workers: finite losses, ms per commit (the first chunk
   apart), tokens/s, peak memory, and the Langevin update and the one-pass
   W-Icon read each launched once per parameter leaf per commit (14 x 6),
   the standalone gather and delay draw never; then the torch twin of
   ``examples/train_lm.py`` (110M parameters, 12 query heads over 4 KV
   heads) for 4 commits and its greedy decode through ``DecodeEngine``: the
   ring kernel at a group of 3, once per layer per decode step;
7. the main path, part 4: the paper's experiments (``repro_torch.
   experiments``), Sync, W-Con and W-Icon — (a) the §3.2 regression (P 4,
   400 steps) and the §3.3 RICA (patch 16, 8 features, 60 steps) at
   sigma 0 on the card and on the CPU: the same iterations, simulated times
   and speedups, trajectories, W2, objectives and distances within 1e-5 +
   1e-4 x |CPU|; (b) the regression chain through the fused preset at the
   published gamma and sigma, W-Con and W-Icon, 400 commits, card against
   CPU likewise (the same noise bits), every iterate distinct; (c) both
   experiments at their published settings on the card (regression P 18,
   nu 0.1, 6000 steps, batch 256; RICA P 4, nu 0.01, 800 steps, batch 512,
   64 x 48), each final W2, objective and distance inside the band of
   ``tests/fixtures/torch_paper_reference.json`` around the JAX package's
   value and each speedup equal to it, with wall seconds, commits a second
   and the delay kernels' launches a commit (one draw and one gather a
   W-Icon commit);
8. the main path, part 5: the multi-chain ``ClusterEngine`` — (a) 8 chains
   x 37 commits of a d=4 quadratic (tau 8, schedules from 4 simulated
   workers) through the fused W-Icon preset at sigma 0.5, on the card and
   on the CPU (the same noise bits): within 1e-5 + 1e-4 x |CPU|, and chain
   c on the card bit for bit the card's single-chain ``Engine``; (b) the
   torch cluster quickstart's scenario at its own settings (32 chains, 8
   workers, 600 commits): ``sgld``, ``svrg`` and ``sghmc`` W-Con, the
   inverse-speed half, then the 32 chains through the fused W-Icon preset
   (one update and one read launch a commit for all 32): final W2, wall
   seconds, commits a second; (d) the torch serve quickstart at its own
   settings (32 chains, 8 workers, 4,000 W-Con commits of the polynomial
   regression, ``save_ensemble``, ``ServeEngine.from_checkpoint``): means
   and 90% intervals against the closed-form posterior predictive
   (``torch_serve_quickstart.check``); (c) a 4-chain ensemble of qwen3-4b at its
   published widths, depth cut to 4 layers (bf16, drawn on the card),
   fused W-Icon at tau 2, schedules from 8 simulated workers, a batch of 8
   x 128 tokens a chain drawn by ``batch_fn``, 3 commits in one chunk:
   finite losses, ms a commit, peak memory, and the update and the read
   each launched 14 x 3 times (once a leaf a commit, whatever C);
9. the main path, part 6: faults, checkpoints and self-healing — (a) the
   ``ClusterEngine`` under a ``FaultPlan`` chaos schedule and a
   ``nan_storm`` with ``health_check`` and respawn, 8 chains x 40 commits
   of the d=4 quadratic (tau 32), fused W-Icon and fused W-Con, card
   against CPU: iterates within 1e-5 + 1e-4 x |CPU|, health masks, respawn
   counts, keys and ring heads equal; then interrupted at commit 20 and
   resumed from its run checkpoint, bitwise the uninterrupted card run;
   (b) phase 8c's cell again from the same start under ``health_check``,
   one chain losing its last commit and one poisoned at the second: the
   lost commit leaves that chain bitwise (parameters and ring head), the
   poisoned chain is quarantined, restored and respawned from its donor at
   the boundary, the other two chains are bitwise phase 8c's; then
   ``save_ensemble`` (GB, seconds), the engine freed,
   ``DecodeEngine.from_checkpoint`` (seconds) greedy-decodes the tokens
   ``DecodeEngine.from_cluster`` decoded from memory; (c) a run checkpoint
   at full width, cut to 2 chains at 1 layer (tau 1, ~10 GB): restored
   into a fresh carry bitwise, and resumed for one chunk bitwise the
   uninterrupted run.  Checkpoints go to a temporary directory in the
   checkout, deleted after use;
10. the main path, part 7: the model zoo, each config at its published
   widths, random bf16 weights drawn on the card, freed before the next —
   (a) a one-chain bank of minicpm-2b (40 layers), internvl2-1b (24, 256
   vision stub positions), musicgen-medium (48, 64 audio stub positions),
   stablelm-12b (40), qwen1.5-32b (depth cut 64 -> 32), phi3.5-moe (32 ->
   16) and kimi-k2 (61 -> 1: one layer holds 384 x 3 experts of 7168 x
   2048): ``Model.prefill`` of 2 x 64 tokens, 8 greedy tokens through
   ``serve_step`` from an ``init_cache`` ring (the ring kernel once a layer
   a step, at head_dim 112 and 160 and a group of 7 among others), each
   step's logits within 0.1 relative L2 of one prefill of the same stream
   (no kernel; the MoE configs keep every pair and take the decode's
   expert choices there), ms a token, peak GB; stablelm-12b and kimi-k2
   also serve one ``PagedDecodeEngine`` request (the paged kernel at
   head_dim 160 and 112); (b) MoE serving: a 2-chain phi3.5-moe bank at 12
   of 32 layers (63.5 GB) through ``DecodeEngine`` (4 prompts x 32 + 16
   new tokens) and ``PagedDecodeEngine`` (the same on 8 slots, page size
   16), then one ``ServeEngine`` request of 8 x 128 tokens: ms a token,
   tokens/s, ms a request, peak GB, and the dropped (token, expert) pairs
   at the reference's capacity; (c) ``launch.train --arch`` for
   phi3.5-moe at 3 layers (4.16 B parameters) and the whole internvl2-1b
   with its stub batches (``--seq 384``: 256 stub positions and 128
   tokens), 6 fused W-Icon commits each at tau 2, in chunks of 3: finite
   losses, the MoE's aux above 0, ms a commit, peak GB, and the SGLD
   kernels once a leaf a commit;
11. the main path, part 8 — the recurrent configs, hymba-1.5b (attention
   and SSD heads in parallel, a window of 1,024, 25 query heads over 5 KV
   heads) and xlstm-1.3b (a 7:1 mLSTM / sLSTM ``layers`` list), served by
   replay (``init_cache``, then one ``serve_step`` a token: their stacks
   have no prefill-fillable cache, as in the reference) and trained:
   (e) first the reduced float32 hymba at 5 query heads over 1 KV head
   (d_model 320) and the reduced xlstm, 80 tokens replayed on the card
   (the ring kernel at G 5) and on the CPU, logits within 1e-4, and 4
   fused W-Icon commits of each, as phase 3; (a) a 4-chain hymba bank at
   full width and depth (13.1 GB): 4 prompts x 32 tokens replayed, 16
   greedy tokens from the BMA law, the ring kernel once a layer a step,
   each step's logits within 0.1 relative L2 of one forward of the stream,
   then the stream replayed again with each kernel call held against the
   plain step on the same inputs (phase 2's limits, caches equal);
   (c) the same for a 4-chain xlstm bank (16.2 GB, 11.3 GB of mLSTM
   state), gated layer by layer (see ``recurrent_serve``); (b) hymba's
   window at depth 2: one 1,088-token stream through the 1,024-slot ring,
   the last 64 positions against the forward (SDPA under the window
   mask), then held as (a); (d) ``launch.train`` of each at full width (6
   fused W-Icon commits at tau 2, batch 8 x 128; xlstm at gamma 1e-7): ms
   a commit, peak GB, the SGLD kernels once a leaf a commit; the sLSTM
   loop's operations a layer; and xlstm's gradient at init, a layer's
   largest.  Phase 11's seconds and the script's so far are logged;
12. the tooling, at qwen3-4b's published widths with the depth cut to 4
   layers (as the cluster-full cell's): (1) the decode and paged cells'
   traffic on a 4-chain bank, warmed up, then replayed under
   ``instrument()`` with the tracer on: ``stream_flags()`` empty (no new
   rung, no pad scratch), the decode and paged timelines written under
   ``smoke_out/tooling/`` and valid (``validate_chrome_trace``), their
   summaries logged; (2) three fused W-Icon ``ClusterEngine`` commits (C 4,
   tau 2) under ``instrument(transfer_guard="error")``, which the
   fault-free path passes (it reads nothing back), while the same commits
   under ``health_check`` (a flag read a commit) must raise; the run's
   cluster timeline valid; (3) the launcher's training cell at 4 layers
   fed by ``Prefetcher`` (pinned memory, a side stream) and without it in
   one call: the batches bitwise the same, ms a commit of each and the
   share of the batch time hidden (the training thread's time getting a
   prefetched batch against making one inline); (4) the train cell's ``mfu``
   (``launch.roofline.model_flops`` over phase 6's ms a commit and the
   H100's dense bf16 peak), a ``--all`` dry run on ``meta`` timed, and at
   depth 1 the FLOPs counted on the card for one real training step equal
   to the dry run's.  Phase 12's seconds and the script's so far are
   logged.

Before it, one JSON object with the paper path's numbers (phase 7c).
The line before the last is one JSON object with each kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``.  Without a card, or
outside a checkout, it exits non-zero and prints no result.  The
compiler's register and spill report goes to standard error.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (data sheet)
FP32_FLOPS = 67e12         # H100 SXM fp32 outside the tensor cores
# 32-bit ALU operations a second outside the tensor cores: the fp32 rate
# counts an fma as 2 flops, so 67e12 / 2 lane-instructions; integer ops
# run at most at that rate (Hopper's INT32 pipes have half the lanes),
# so a bound from it is a lower bound
ALU_OPS = FP32_FLOPS / 2
L2_BYTES = 50 * 2**20
TOL = {"bfloat16": 2e-2, "float32": 1e-5}  # bf16: one ulp of |o| <= 4
# (KV heads, query heads a KV head, head_dim): qwen3-4b's, and the 110M
# example model's 12 query heads over 4 KV heads (a group of 3)
QWEN_HEADS, LM100M_HEADS = (8, 4, 128), (4, 3, 64)
# the model zoo's shapes the kernels gained: kimi-k2's head_dim 112 at G 8,
# stablelm-12b's 160 at G 4, internvl2-1b's group of 7 at head_dim 64
ZOO_HEADS = {"kimi-k2-1t-a32b": (8, 8, 112), "stablelm-12b": (8, 4, 160),
             "internvl2-1b": (2, 7, 64)}
# phase 10a: each config at its published widths, a one-chain bank at this
# depth (the configs' own depth unless the card cannot hold it)
ZOO_DEPTH = {"minicpm-2b": 40, "internvl2-1b": 24, "musicgen-medium": 48,
             "stablelm-12b": 40, "qwen1.5-32b": 32, "phi3.5-moe-42b-a6.6b": 16,
             "kimi-k2-1t-a32b": 1}
# decode logits against a prefill of the same tokens, in bf16: the largest
# relative L2 error a step may have, and the least a step must have against
# the prefill's neighbouring position (see zoo_config)
ZOO_REL_TOL, ZOO_SHIFT_MIN = 0.1, 0.5
MOE_SERVE_LAYERS, MOE_TRAIN_LAYERS = 12, 3  # phases 10b and 10c, of 32
# phase 11: hymba-1.5b's heads (25 query heads over 5 KV heads, a group of
# 5); the recurrent serving banks' chains; 11b's depth and stream (17 x 64
# tokens past hymba's 1,024-token window)
HYMBA_HEADS = (5, 5, 64)
# (smax, valid rows, slot, rows) of the ring kernel at G 5 as hymba's serving
# gives it: 11a's 48-slot ring of 16 rows (4 chains x 4 rows) filling up and
# full, and 11b's 1,024-slot ring of one row, filling up and wrapped (every
# slot inside the window)
HYMBA_RING_CASES = ((48, 32, 31, 16), (48, 48, 47, 16), (1024, 600, 599, 1),
                    (1024, 1024, 63, 1))
RECURRENT_CHAINS = 4
WINDOW_LAYERS, WINDOW_TOKENS = 2, 17 * 64
# 11d's step sizes: qwen3-4b's cell's 1e-3 for hymba; xlstm's gradient at
# its random init reaches 3e4 at 48 layers (11d measures it, xlstm_grad_scale;
# scripts/torch_recurrent_witness.py holds it against the JAX package's at
# 8 and 16 layers), so a step of 1e-3 would move a weight by 30: it trains
# at 1e-7
RECURRENT_TRAIN_GAMMA = {"hymba-1.5b": "1e-3", "xlstm-1.3b": "1e-7"}
LARGEST_LEAF = 36 * 2560 * 9728  # stack/mlp/w_{gate,up,down} of qwen3-4b
STACK4_LEAF = 4 * 2560 * 9728    # the same leaf at phase 8c's 4 layers
EMBED_LEAF = 151936 * 2560       # the embedding (and the untied head)
CLUSTER_LAYERS = 4               # phase 8c: qwen3-4b's widths, depth cut
RAGGED = 1_000_003
# 32-bit operations per element, counted from the sources: threefry2x32-20
# is 20 rounds of (add, rotate, xor) plus 12 key-schedule adds
THREEFRY_OPS = 72
# + counter xor, 2 x (shift, convert, mul, add), log, cos, sqrt, 3 muls,
# 2 fmas, 2 type conversions
LANGEVIN_OPS = THREEFRY_OPS + 1 + 8 + 3 + 3 + 2 + 2
# two threefry blocks + 2 xors + 3 remainders, a multiply, an add, a convert
DELAY_OPS = 2 * THREEFRY_OPS + 8

# the paper's experiments at their published settings; the JAX package's
# values there, and the band the card's must fall in, come from
# scripts/torch_paper_reference.py (a test holds the fixture's settings to
# these)
MODES = ["sync", "consistent", "inconsistent"]
PUBLISHED = {
    "regression": dict(P=18, nu=0.1, steps=6000, gamma=2e-4, sigma=1e-3,
                       batch=256, tau_cap=16, seed=0, modes=MODES),
    "rica": dict(P=4, nu=0.01, steps=800, gamma=2e-3, batch=512, patch_dim=64,
                 num_features=48, tau_cap=8, seed=0, modes=MODES),
}
REFERENCE = ROOT / "tests" / "fixtures" / "torch_paper_reference.json"
# card against CPU at sigma = 0, where only float arithmetic differs
# (cuBLAS, cuFFT and cuSOLVER against the CPU's libraries)
PAPER_RTOL, PAPER_ATOL = 1e-4, 1e-5


def log(*parts) -> None:
    print(" ".join(str(p) for p in parts), flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
def cuda_ms(torch, fns, iters: int) -> float:
    """Mean device ms of one call, cycling through ``fns`` (one per input
    set, so that the sets together exceed the L2 cache and each call finds
    its inputs in device memory, as on the serving path)."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(torch, fns, iters: int) -> float:
    """Mean device ms of one call, as ``cuda_ms``, from replays of a CUDA
    graph of ``iters`` calls: the host's time to enqueue a call (the
    wrappers' checks, allocations and ctypes, tens of microseconds) is left
    out, so a kernel shorter than that is timed, not the host."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    stop.synchronize()
    del graph
    return start.elapsed_time(stop) / iters


def n_sets(bytes_per_set: int) -> int:
    return max(2, math.ceil(2 * L2_BYTES / bytes_per_set))


def bound(bytes_moved: float, flops: float, rate: float = FP32_FLOPS) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def decode_inputs(torch, gen, dtype, N, smax, n_valid, slot, KV=8, G=4, hd=128):
    dev = "cuda"
    r = lambda *s: torch.randn(*s, generator=gen, device=dev).to(dtype)  # noqa: E731
    valid = torch.zeros(smax, dtype=torch.int32, device=dev)
    valid[:n_valid] = 1
    valid[slot] = 1
    return dict(q=r(N, KV, G, hd), k_new=r(N, KV, hd), v_new=r(N, KV, hd),
                k_cache=r(N, smax, KV, hd), v_cache=r(N, smax, KV, hd),
                valid=valid, slot=slot)


def paged_inputs(torch, gen, dtype, C, pos, ps=16, maxp=16, KV=8, G=4, hd=128):
    """One pool per chain, slots on a permuted page table; slots with
    ``pos`` None are inactive: table row 0, position 0 (the garbage page)."""
    dev = "cuda"
    S = len(pos)
    n_pages = S * maxp + 1
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(5)) + 1
    tables = torch.zeros(S, maxp, dtype=torch.int32)
    nxt = 0
    for s, p in enumerate(pos):
        if p is not None:
            n = p // ps + 1
            tables[s, :n] = perm[nxt:nxt + n]
            nxt += n
    r = lambda *s: torch.randn(*s, generator=gen, device=dev).to(dtype)  # noqa: E731
    return dict(q=r(C, S, KV, G, hd), k_new=r(C, S, KV, hd),
                v_new=r(C, S, KV, hd), k_pages=r(C, n_pages, ps, KV, hd),
                v_pages=r(C, n_pages, ps, KV, hd), tables=tables.to(dev),
                pos=torch.tensor([p or 0 for p in pos], dtype=torch.int32,
                                 device=dev))


def decode_limit(torch, name: str, want):
    """The limit on a decode kernel's |err| against its plain version, per
    row or slot (over its KV heads x G x hd outputs): ``TOL``, and in
    bfloat16 also two bf16 ulps of the row's largest plain output.  ``TOL``
    alone is one ulp of an output up to 4, but a long context's output is
    small (|o| ~ sqrt(e / n) over n random rows: ~0.013 at 16,384), where
    2e-2 would pass a kernel that dropped a split."""
    tol = torch.full((*want.shape[:-3], 1, 1, 1), TOL[name], device=want.device)
    if name != "bfloat16":
        return tol
    m = want.float().abs().amax(dim=(-3, -2, -1), keepdim=True)
    return torch.where(m > 0, torch.minimum(tol, torch.exp2(torch.floor(torch.log2(m)) - 6)), tol)


def within(torch, got, want, limit) -> bool:
    return bool(((got.float() - want.float()).abs() <= limit).all())


def bitwise_equal(torch, a, b) -> bool:
    return torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def run_decode_case(torch, F, ds, ref, dtype, smax, n_valid, slot, timed,
                    plain_iters=50, heads=QWEN_HEADS, N=16):
    """``N`` rows: C = 4 chains x B = 4 rows by default."""
    gen = torch.Generator(device="cuda").manual_seed(smax + n_valid)
    KV, G, hd = heads
    c = decode_inputs(torch, gen, dtype, N, smax, n_valid, slot, KV, G, hd)
    kc, vc = c["k_cache"].clone(), c["v_cache"].clone()
    o, kc, vc = ds.decode_step(c["q"], c["k_new"], c["v_new"], kc, vc,
                               c["valid"], slot)
    again = ds.decode_step(c["q"], c["k_new"], c["v_new"], kc, vc,
                           c["valid"], slot)[0]
    want, wk, wv = ref.decode_step_ref(c["q"], c["k_new"], c["v_new"],
                                       c["k_cache"].clone(),
                                       c["v_cache"].clone(), c["valid"], slot)
    torch.cuda.synchronize()
    err = (o.float() - want.float()).abs().max().item()
    name = str(dtype).replace("torch.", "")
    limit = decode_limit(torch, name, want)
    check(within(torch, o, want, limit),
          f"decode_step {name} smax={smax}: max |err| {err} past the limit "
          f"(smallest {limit.min().item()})")
    check(torch.equal(kc, wk) and torch.equal(vc, wv),
          f"decode_step {name} smax={smax}: caches differ from the plain step")
    check(bitwise_equal(torch, o, again),
          f"decode_step {name} smax={smax}: two calls differ")
    splits, chunk = ds.ring_plan(smax)
    if splits > 1:  # the limit sees a ring that misses split 0's rows
        drop = c["valid"].clone()
        drop[:chunk] = 0
        drop[slot] = 1
        off = ref.decode_step_ref(c["q"], c["k_new"], c["v_new"],
                                  c["k_cache"].clone(), c["v_cache"].clone(),
                                  drop, slot)[0]
        check(not within(torch, off, want, limit),
              f"decode_step {name} smax={smax}: the plain step without "
              "split 0's rows is within the limit")
        del off
    del want, wk, wv, again
    changed = (kc != c["k_cache"]).any(dim=(0, 2, 3)).nonzero().flatten().tolist()
    check(set(changed) <= {slot}, f"decode_step wrote rows {changed}")
    res = {"dtype": name, "heads": list(heads), "rows": N, "smax": smax, "valid": n_valid,
           "max_abs_err": err, "limit": limit.min().item(), "splits": splits}
    if not timed:
        log("decode_step", json.dumps(res))
        return res
    es = c["q"].element_size()
    row = KV * hd * es
    n_read = int(c["valid"].sum().item()) - 1  # the slot row comes from k_new
    bytes_moved = (c["q"].numel() * es * 2 + 2 * N * row + smax * 4
                   + 2 * N * n_read * row + 2 * N * row)
    flops = 4.0 * N * KV * G * hd * (n_read + 1)
    sets = [decode_inputs(torch, gen, dtype, N, smax, n_valid, slot, KV, G, hd)
            for _ in range(n_sets(2 * N * smax * row))]
    mask = [s["valid"].bool().reshape(1, 1, 1, smax) for s in sets]
    kern = [lambda s=s: ds.decode_step(s["q"], s["k_new"], s["v_new"],
                                       s["k_cache"], s["v_cache"], s["valid"],
                                       slot) for s in sets]
    plain = [lambda s=s: ref.decode_step_ref(s["q"], s["k_new"], s["v_new"],
                                             s["k_cache"], s["v_cache"],
                                             s["valid"], slot) for s in sets]
    lib = [lambda s=s, m=m: F.scaled_dot_product_attention(
        s["q"].reshape(N, KV * G, 1, hd), s["k_cache"].transpose(1, 2),
        s["v_cache"].transpose(1, 2), attn_mask=m, enable_gqa=True)
        for s, m in zip(sets, mask)]
    res["ms"] = graph_ms(torch, kern, 200)
    res["eager_ms"] = cuda_ms(torch, kern, 200)
    res["plain_ms"] = cuda_ms(torch, plain, plain_iters)
    res["library_ms"] = graph_ms(torch, lib, 200)
    res["library_eager_ms"] = cuda_ms(torch, lib, 200)
    res["bytes"] = bytes_moved
    res["bound_ms"], res["bound_by"] = bound(bytes_moved, flops)
    log("decode_step", json.dumps(res))
    return res


PAGED_CELL = [40, 95, 130, 7, 200, None, None, 255]  # 8 slots, 2 inactive
# 4,096-position windows: positions spread over the window, 2 inactive
PAGED_LONG = [4095, 2048, 17, None, 3000, 1023, None, 600]
# (smax, valid rows, slot): the decode cell's ring, a full 1024-slot ring,
# and a 16,384-slot ring (refused before the kernel was split)
RING_CASES = ((256, 48, 47), (1024, 1024, 1000), (16384, 16384, 9000))
# (positions, pages a slot): the paged cell and 4,096-position windows
PAGED_CASES = ((PAGED_CELL, 16), (PAGED_LONG, 256))


def run_paged_case(torch, F, ds, ref, dtype, timed, pos=PAGED_CELL, maxp=16,
                   plain_iters=50, heads=QWEN_HEADS):
    gen = torch.Generator(device="cuda").manual_seed(7 + maxp)
    C, ps = 4, 16
    KV, G, hd = heads
    c = paged_inputs(torch, gen, dtype, C, pos, maxp=maxp, KV=KV, G=G, hd=hd)
    kp, vp = c["k_pages"].clone(), c["v_pages"].clone()
    o, kp, vp = ds.paged_decode_step(c["q"], c["k_new"], c["v_new"], kp, vp,
                                     c["tables"], c["pos"])
    again = ds.paged_decode_step(c["q"], c["k_new"], c["v_new"], kp, vp,
                                 c["tables"], c["pos"])[0]
    want, wk, wv = ref.paged_decode_step_ref(
        c["q"], c["k_new"], c["v_new"], c["k_pages"].clone(),
        c["v_pages"].clone(), c["tables"], c["pos"])
    torch.cuda.synchronize()
    err = (o.float() - want.float()).abs().max().item()
    name = str(dtype).replace("torch.", "")
    limit = decode_limit(torch, name, want)
    check(within(torch, o, want, limit),
          f"paged_decode_step {name} maxp={maxp}: max |err| {err} past the "
          f"limit (smallest {limit.min().item()})")
    check(bitwise_equal(torch, o, again),
          f"paged_decode_step {name} maxp={maxp}: two calls differ")
    S = len(pos)
    inactive = [s for s, p in enumerate(pos) if p is None]
    for got, plain, new, src in ((kp, wk, c["k_new"], c["k_pages"]),
                                 (vp, wv, c["v_new"], c["v_pages"])):
        # every row but the garbage row (page 0, offset 0) bit-for-bit; the
        # inactive slots race on the garbage row element by element, so
        # each element of it is that element of one of their new rows
        g, w = got.clone(), plain.clone()
        g[:, 0, 0] = 0
        w[:, 0, 0] = 0
        check(torch.equal(g, w), f"paged_decode_step {name}: pools differ")
        cands = new[:, inactive]  # (C, inactive, KV, hd)
        check(bool((cands == got[:, 0, 0][:, None]).any(dim=1).all()),
              f"paged_decode_step {name}: garbage row holds a foreign value")
        rows = (got != src).any(dim=(3, 4)).nonzero().tolist()
        written = {(int(c["tables"][s, p // ps]), p % ps)
                   for s, p in enumerate(pos) if p is not None} | {(0, 0)}
        check({(r[1], r[2]) for r in rows} <= written,
              f"paged_decode_step {name}: wrote outside the slot rows")
    del want, wk, wv, again
    res = {"dtype": name, "heads": list(heads), "slots": S, "maxp": maxp, "pos": pos,
           "max_abs_err": err, "limit": limit.min().item(),
           "splits": ds.paged_plan(maxp)}
    if not timed:
        log("paged_decode_step", json.dumps(res))
        return res
    es = c["q"].element_size()
    row = KV * hd * es
    n_read = sum(p for p in pos if p is not None)  # rows 0..p-1 per slot
    bytes_moved = (c["q"].numel() * es * 2 + 2 * C * S * row
                   + c["tables"].numel() * 4 + S * 4
                   + 2 * C * n_read * row + 2 * C * S * row)
    flops = 4.0 * C * KV * G * hd * sum((p or 0) + 1 for p in pos)
    pool_bytes = 2 * c["k_pages"].numel() * es
    sets = [paged_inputs(torch, gen, dtype, C, pos, maxp=maxp, KV=KV, G=G, hd=hd)
            for _ in range(n_sets(pool_bytes))]
    kern = [lambda s=s: ds.paged_decode_step(s["q"], s["k_new"], s["v_new"],
                                             s["k_pages"], s["v_pages"],
                                             s["tables"], s["pos"]) for s in sets]
    plain = [lambda s=s: ref.paged_decode_step_ref(
        s["q"], s["k_new"], s["v_new"], s["k_pages"], s["v_pages"],
        s["tables"], s["pos"]) for s in sets]
    # the library yardstick attends over each slot's window gathered into
    # logical order beforehand (the gather is not timed)
    win = maxp * ps
    lib_sets = []
    for s in sets:
        gidx = (s["tables"].long() * ps)[:, :, None] + torch.arange(ps, device="cuda")
        gidx = gidx.reshape(S, win)
        kf = s["k_pages"].reshape(C, -1, KV, hd)[:, gidx]  # (C, S, win, KV, hd)
        vf = s["v_pages"].reshape(C, -1, KV, hd)[:, gidx]
        m = (torch.arange(win, device="cuda")[None] <= s["pos"][:, None].long())
        lib_sets.append((s["q"].reshape(C * S, KV * G, 1, hd),
                         kf.reshape(C * S, win, KV, hd).transpose(1, 2).contiguous(),
                         vf.reshape(C * S, win, KV, hd).transpose(1, 2).contiguous(),
                         m.repeat(C, 1)[:, None, None, :]))
    lib = [lambda a=a: F.scaled_dot_product_attention(
        a[0], a[1], a[2], attn_mask=a[3], enable_gqa=True) for a in lib_sets]
    res["ms"] = graph_ms(torch, kern, 200)
    res["eager_ms"] = cuda_ms(torch, kern, 200)
    res["plain_ms"] = cuda_ms(torch, plain, plain_iters)
    res["library_ms"] = graph_ms(torch, lib, 200)
    res["library_eager_ms"] = cuda_ms(torch, lib, 200)
    res["bytes"] = bytes_moved
    res["bound_ms"], res["bound_by"] = bound(bytes_moved, flops)
    log("paged_decode_step", json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# phase 2, continued: the SGLD kernels against their plain versions
# ---------------------------------------------------------------------------
def within_bf16_ulp(torch, got, want) -> bool:
    got, want = got.float(), want.float()
    return bool(((got - want).abs() <= want.abs() * 2.0**-7 + 1e-30).all())


def _device_table(torch, np, rows):
    return torch.from_numpy(np.ascontiguousarray(rows).view(np.int32)).to("cuda")


def update_one(torch, np, lu, x, g, seed, gamma, scale):
    """The update kernel on one chain (C = 1), in place on x."""
    table = _device_table(torch, np, lu.chain_rows([seed], [gamma], [scale]))
    return lu.langevin_update(x[None], g[None], table)[0]


def update_ref_one(ref, x, g, seed, gamma, scale):
    return ref.langevin_update_ref(x[None], g[None], [seed], [gamma], [scale])[0]


def run_langevin_checks(torch, np, lu, ref) -> dict:
    """The fused update against the plain update: ragged bf16 / f32 (the
    vector code and its tail; one element off 16 bytes, the scalar code),
    the noise alone, and the largest full-width leaf (timed there)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    seed, gamma, scale = (0x1234ABCD, 77), np.float32(1e-3), np.float32(0.03)
    out = {}
    for dtype, off in ((torch.bfloat16, 0), (torch.float32, 0),
                       (torch.bfloat16, 1), (torch.float32, 1)):
        name = str(dtype).replace("torch.", "") + ("_offset" if off else "")
        x = torch.randn(off + RAGGED, generator=gen, device="cuda").to(dtype)[off:]
        g = torch.randn(off + RAGGED, generator=gen, device="cuda").to(dtype)[off:]
        want = update_ref_one(ref, x.clone(), g, seed, gamma, scale)
        update_one(torch, np, lu, x, g, seed, gamma, scale)
        zero = torch.zeros(RAGGED, device="cuda", dtype=dtype)
        noise_want = update_ref_one(ref, zero.clone(), g, seed, np.float32(0),
                                    np.float32(1))
        update_one(torch, np, lu, zero, g, seed, np.float32(0), np.float32(1))
        torch.cuda.synchronize()
        for what, got, w in (("update", x, want), ("noise", zero, noise_want)):
            err = (got.float() - w.float()).abs().max().item()
            ok = (err <= 2e-6 if dtype == torch.float32
                  else within_bf16_ulp(torch, got, w))
            check(ok, f"langevin_update {name} n={RAGGED} {what}: max |err| {err}")
            out[f"{name}_{what}_max_abs_err"] = err
    # the largest leaf, bf16, at the launcher's gamma and sigma
    n = LARGEST_LEAF
    x = (torch.randn(n, generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
    g = (torch.randn(n, generator=gen, device="cuda") * 1e-2).to(torch.bfloat16)
    scale = np.sqrt(np.float32(2.0 * 1e-5) * gamma)
    want = update_ref_one(ref, x.clone(), g, seed, gamma, scale)
    update_one(torch, np, lu, x, g, seed, gamma, scale)
    torch.cuda.synchronize()
    err = (x.float() - want.float()).abs().max().item()
    check(within_bf16_ulp(torch, x, want),
          f"langevin_update bf16 n={n}: beyond one bf16 ulp (max |err| {err})")
    del want
    out["max_abs_err"] = err
    table = _device_table(torch, np, lu.chain_rows([seed], [gamma], [scale]))
    out["ms"] = cuda_ms(torch, [lambda: lu.langevin_update(x[None], g[None], table)], 20)
    out["plain_ms"] = cuda_ms(torch, [lambda: update_ref_one(ref, x, g, seed, gamma,
                                                             scale)], 2)
    out["bytes"] = 3 * 2 * n  # read x and g, write x, bf16
    out["ops"] = LANGEVIN_OPS * n
    out["bound_ms"], out["bound_by"] = bound(out["bytes"], out["ops"], ALU_OPS)
    out["library_ms"] = None  # no PyTorch call draws threefry noise
    # beside it, not a yardstick: randn_like + two add_ (another RNG)
    out["randn_add_ms"] = cuda_ms(torch, [lambda: x.add_(g, alpha=-1e-3).add_(
        torch.randn_like(x), alpha=float(scale))], 10)
    log("langevin_update", json.dumps(out))
    return out


def ring_of(torch, gen, dtype, depth, n):
    """A (depth, n) ring with signed zeros, inf and nan in its first row."""
    h = torch.randn(depth, n, generator=gen, device="cuda")
    h[0, :4] = torch.tensor([-0.0, float("inf"), float("nan"), -0.0])
    if dtype == torch.int32:
        return (h.nan_to_num(0, 9, -9) * 1000).to(dtype)
    return h.to(dtype)


def draw_table(torch, np, dg, key, maxval, head=0):
    return _device_table(torch, np, dg.randint_rows([key], [maxval], [head]))


def run_gather_checks(torch, np, dg, ref) -> tuple:
    """The delay draw, the gather and the one-pass W-Icon read against
    their plain versions: ragged (the scalar code) and 2^20 elements (the
    vector code) in f32 / bf16 / int32 (signed zeros, inf and nan), rings
    of depth 1-5, then the largest full-width leaf over a 3-slot ring
    (timed there)."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    for maxval in (1, 2, 3, 7, 4097, 65535):
        got = dg.coordinate_delays(draw_table(torch, np, dg, (123, 456), maxval),
                                   RAGGED, [maxval])
        want = ref.coordinate_delays_ref([(123, 456)], RAGGED, [maxval], "cuda")
        check(torch.equal(got, want), f"coordinate_delays maxval={maxval}: "
              "the kernel's delays differ from the plain draw")
    reads = 0
    for n in (RAGGED, 1 << 20):
        for dtype in (torch.float32, torch.bfloat16, torch.int32):
            for depth in range(1, 6):
                h = ring_of(torch, gen, dtype, depth, n)[None]  # one chain: C = 1
                head = (n + depth) % depth
                # out-of-range delays: negative and >= depth
                d = torch.randint(-2 * depth, 2 * depth, (1, n), generator=gen,
                                  device="cuda", dtype=torch.int32)
                check(bitwise_equal(torch, dg.delay_gather(h, d, [head]),
                                ref.delay_gather_ref(h, d, [head])),
                      f"delay_gather {dtype} n={n} depth={depth}: not bit for "
                      "bit the plain gather")
                for maxval in sorted({1, (depth + 1) // 2, depth}):
                    key = (n + maxval, depth)
                    check(bitwise_equal(torch, dg.wicon_read(
                        h, draw_table(torch, np, dg, key, maxval, head), [maxval], [head]),
                        ref.wicon_read_ref(h, [key], [maxval], [head])),
                          f"wicon_read {dtype} n={n} depth={depth} maxval="
                          f"{maxval}: not bit for bit the plain read")
                    reads += 1
    log(f"wicon_read: {reads} reads bit for bit the plain read (n {RAGGED} "
        f"and {1 << 20}, f32/bf16/int32, depth 1-5)")
    n, depth, head, key = LARGEST_LEAF, 3, 2, (0xC0FFEE, 9)
    hist = torch.randn(1, depth, n, generator=gen, device="cuda").to(torch.bfloat16)
    table = draw_table(torch, np, dg, key, depth, head)
    got, want = dg.wicon_read(hist, table, [depth], [head]), ref.wicon_read_ref(
        hist, [key], [depth], [head])
    check(bitwise_equal(torch, got, want),
          f"wicon_read n={n}: not bit for bit the plain read")
    del got, want
    wic = {"entry": "wicon_read", "max_abs_err": 0.0,
           "ms": cuda_ms(torch, [lambda: dg.wicon_read(hist, table, [depth], [head])], 20),
           "plain_ms": cuda_ms(torch, [lambda: ref.wicon_read_ref(
               hist, [key], [depth], [head])], 1),
           "library_ms": None,  # no one PyTorch call draws and gathers
           "bytes": n * (2 + 2), "ops": DELAY_OPS * n}  # element in, out
    wic["bound_ms"], wic["bound_by"] = bound(wic["bytes"], wic["ops"], ALU_OPS)
    delays = dg.coordinate_delays(table, n, [depth])
    check(torch.equal(delays, ref.coordinate_delays_ref([key], n, [depth], "cuda")),
          f"coordinate_delays n={n}: differs from the plain draw")
    got, want = dg.delay_gather(hist, delays, [head]), ref.delay_gather_ref(
        hist, delays, [head])
    check(bitwise_equal(torch, got, want),
          f"delay_gather n={n}: not bit for bit the plain gather")
    slots = torch.remainder(head - delays.long(), depth)[:, None]
    del got, want
    gat = {"entry": "delay_gather", "max_abs_err": 0.0,
           "ms": cuda_ms(torch, [lambda: dg.delay_gather(hist, delays, [head])], 20),
           "plain_ms": cuda_ms(torch, [lambda: ref.delay_gather_ref(
               hist, delays, [head])], 5),
           "library_ms": cuda_ms(torch, [lambda: torch.gather(hist, 1, slots)], 10),
           "bytes": n * (4 + 2 + 2), "ops": 4 * n}  # delay, element in, out
    gat["bound_ms"], gat["bound_by"] = bound(gat["bytes"], gat["ops"], ALU_OPS)
    del slots
    dly = {"max_abs_err": 0.0,
           "ms": cuda_ms(torch, [lambda: dg.coordinate_delays(table, n, [depth])], 10),
           "plain_ms": cuda_ms(torch, [lambda: ref.coordinate_delays_ref(
               [key], n, [depth], "cuda")], 1),
           "library_ms": None,  # torch.randint is another RNG
           "bytes": 4 * n, "ops": DELAY_OPS * n}
    dly["bound_ms"], dly["bound_by"] = bound(dly["bytes"], dly["ops"], ALU_OPS)
    log("wicon_read", json.dumps(wic))
    log("delay_gather", json.dumps(gat))
    log("coordinate_delays", json.dumps(dly))
    return wic, gat, dly


def _timed_once(torch, fn):
    """(result, device ms) of one call (a plain version, too slow to
    repeat at full width)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return out, start.elapsed_time(stop)


def _draw_ops(maxvals) -> float:
    """32-bit operations a coordinate of the chains' draws, as this run's
    maxvals need them: none at 1, one threefry stream where 2^32 mod
    maxval is 0, else both (DELAY_OPS)."""
    per = [0 if m == 1 else THREEFRY_OPS + 4 if (m & (m - 1)) == 0 else DELAY_OPS
           for m in maxvals]
    return sum(per) / len(per)


def run_chain_checks(torch, np, lu, dg, ref) -> dict:
    """The kernels on C chains in one launch against their plain versions
    and against the same kernels on each chain alone (C = 1): C 32 on a
    5-element and a ragged leaf (bf16 and f32; rows off 16 bytes), then
    C 4 on the 4-layer stacked largest leaf and the embedding (bf16, the
    chains at maxvals 3, 3, 2 and 1: both draw streams, the low one alone,
    none), timed there."""
    from repro_torch.kernels import rng

    gen = torch.Generator(device="cuda").manual_seed(17)
    for C, n in ((32, 5), (32, RAGGED)):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(C, n, generator=gen, device="cuda").to(dtype)
            g = torch.randn(C, n, generator=gen, device="cuda").to(dtype)
            seeds = rng.split((n, C), C)
            gammas = np.linspace(1e-3, 5e-2, C).astype(np.float32)
            scales = np.linspace(0.0, 0.3, C).astype(np.float32)
            want = ref.langevin_update_ref(x.clone(), g, seeds, gammas, scales)
            single = [update_one(torch, np, lu, x[c].clone(), g[c].clone(), seeds[c],
                                 gammas[c], scales[c]) for c in range(C)]
            lu.langevin_update(x, g, _device_table(
                torch, np, lu.chain_rows(seeds, gammas, scales)))
            torch.cuda.synchronize()
            err = (x.float() - want.float()).abs().max().item()
            check(all(bitwise_equal(torch, x[c], single[c]) for c in range(C)),
                  f"langevin_update C={C} n={n} {dtype}: not each chain alone")
            check(err <= 2e-6 if dtype == torch.float32 else within_bf16_ulp(torch, x, want),
                  f"langevin_update C={C} n={n} {dtype}: max |err| {err}")
            h = torch.randn(C, 3, n, generator=gen, device="cuda").to(dtype)
            keys, maxvals = rng.split((C, n), C), [1 + c % 3 for c in range(C)]
            heads = [(1 + c) % 3 for c in range(C)]  # parted by masked commits
            table = _device_table(torch, np, dg.randint_rows(keys, maxvals, heads))
            got = dg.wicon_read(h, table, maxvals, heads)
            check(bitwise_equal(torch, got, ref.wicon_read_ref(h, keys, maxvals, heads))
                  and all(bitwise_equal(torch, got[c], dg.wicon_read(
                      h[c:c + 1].clone(), draw_table(torch, np, dg, keys[c], maxvals[c],
                                                     heads[c]),
                      [maxvals[c]], [heads[c]])[0]) for c in range(C)),
                  f"wicon_read C={C} n={n} {dtype}: not bit for bit")
            wild = (torch.randint(-7, 9, (C, n), generator=gen, device="cuda")
                    .to(torch.int32))
            got = dg.delay_gather(h, wild, heads)
            check(bitwise_equal(torch, got, ref.delay_gather_ref(h, wild, heads))
                  and all(bitwise_equal(torch, got[c], dg.delay_gather(
                      h[c:c + 1].clone(), wild[c:c + 1].clone(), [heads[c]])[0])
                      for c in range(C)),
                  f"delay_gather C={C} n={n} {dtype} (a head a chain): not bit for bit")
            d = dg.coordinate_delays(table, n, maxvals)
            check(torch.equal(d, ref.coordinate_delays_ref(keys, n, maxvals, "cuda")),
                  f"coordinate_delays C={C} n={n}: not the plain draw")
    log("chain-axis kernels: C 32 on 5 and 1,000,003 elements (bf16, f32) == "
        "the plain versions and each chain alone (C = 1)")
    cases = {"update": [], "read": [], "draw": [], "gather": []}
    C, maxvals = 4, [3, 3, 2, 1]
    for leaf, n in (("stack4", STACK4_LEAF), ("embedding", EMBED_LEAF)):
        seeds = rng.split((n, C), C)
        gammas = np.full(C, 1e-3, np.float32)
        scales = np.full(C, np.sqrt(np.float32(2e-5) * np.float32(1e-3)), np.float32)
        x = (torch.randn(C, n, generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
        g = (torch.randn(C, n, generator=gen, device="cuda") * 1e-2).to(torch.bfloat16)
        table = _device_table(torch, np, lu.chain_rows(seeds, gammas, scales))
        want, plain_ms = _timed_once(torch, lambda: ref.langevin_update_ref(
            x.clone(), g, seeds, gammas, scales))
        single = x[0].clone()
        update_one(torch, np, lu, single, g[0], seeds[0], gammas[0], scales[0])
        lu.langevin_update(x, g, table)
        torch.cuda.synchronize()
        err = (x.float() - want.float()).abs().max().item()
        check(within_bf16_ulp(torch, x, want) and bitwise_equal(torch, x[0], single),
              f"langevin_update {leaf}: max |err| {err} or chain 0 differs")
        del want, single
        row = {"leaf": leaf, "chains": C, "n": n, "max_abs_err": err,
               "ms": cuda_ms(torch, [lambda: lu.langevin_update(x, g, table)], 10),
               "plain_ms": plain_ms, "library_ms": None,
               "bytes": 3 * 2 * C * n, "ops": LANGEVIN_OPS * C * n}
        row["bound_ms"], row["bound_by"] = bound(row["bytes"], row["ops"], ALU_OPS)
        cases["update"].append(row)
        del x, g
        torch.cuda.empty_cache()
        h = torch.randn(C, 3, n, generator=gen, device="cuda").to(torch.bfloat16)
        keys, head = rng.split((C, n + 1), C), 2
        heads = [head] * C  # every chain committed: the fault-free heads
        table = _device_table(torch, np, dg.randint_rows(keys, maxvals, heads))
        want, plain_ms = _timed_once(torch, lambda: ref.wicon_read_ref(
            h, keys, maxvals, heads))
        got = dg.wicon_read(h, table, maxvals, heads)
        check(bitwise_equal(torch, got, want) and bitwise_equal(
            torch, got[0], dg.wicon_read(h[:1].clone(), draw_table(
                torch, np, dg, keys[0], maxvals[0], head), maxvals[:1], [head])[0]),
            f"wicon_read {leaf}: not bit for bit")
        del got, want
        ops = _draw_ops(maxvals) * C * n
        row = {"leaf": leaf, "chains": C, "n": n, "maxvals": maxvals, "max_abs_err": 0.0,
               "ms": cuda_ms(torch, [lambda: dg.wicon_read(h, table, maxvals, heads)], 10),
               "plain_ms": plain_ms, "library_ms": None,
               "bytes": C * n * (2 + 2), "ops": ops}
        row["bound_ms"], row["bound_by"] = bound(row["bytes"], row["ops"], ALU_OPS)
        cases["read"].append(row)
        want, plain_ms = _timed_once(torch, lambda: ref.coordinate_delays_ref(
            keys, n, maxvals, "cuda"))
        d = dg.coordinate_delays(table, n, maxvals)
        check(torch.equal(d, want), f"coordinate_delays {leaf}: not the plain draw")
        del want
        row = {"leaf": leaf, "chains": C, "n": n, "maxvals": maxvals, "max_abs_err": 0.0,
               "ms": cuda_ms(torch, [lambda: dg.coordinate_delays(table, n, maxvals)], 10),
               "plain_ms": plain_ms, "library_ms": None,
               "bytes": 4 * C * n, "ops": ops}
        row["bound_ms"], row["bound_by"] = bound(row["bytes"], row["ops"], ALU_OPS)
        cases["draw"].append(row)
        if leaf == "stack4":
            want, plain_ms = _timed_once(torch, lambda: ref.delay_gather_ref(h, d, heads))
            check(bitwise_equal(torch, dg.delay_gather(h, d, heads), want),
                  f"delay_gather {leaf}: not the plain gather")
            del want
            slots = torch.remainder(head - d.long(), 3)[:, None]
            row = {"leaf": leaf, "chains": C, "n": n, "max_abs_err": 0.0,
                   "ms": cuda_ms(torch, [lambda: dg.delay_gather(h, d, heads)], 10),
                   "plain_ms": plain_ms,
                   "library_ms": cuda_ms(torch, [lambda: torch.gather(h, 1, slots)], 5),
                   "bytes": C * n * (4 + 2 + 2), "ops": 4 * C * n}
            row["bound_ms"], row["bound_by"] = bound(row["bytes"], row["ops"], ALU_OPS)
            cases["gather"].append(row)
            del slots
        del h, d
        torch.cuda.empty_cache()
    for name, rows in cases.items():
        log(f"chain-axis {name}", json.dumps(rows))
    return cases


def run_mask_checks(torch, np, lu, dg, ref) -> dict:
    """The masked commit's kernel cases: C 4 chains, chains 1 and 3
    skipped (their gradient rows NaN), an Inf in chain 2's gradient.
    Skipped rows must be bitwise untouched, kept rows bitwise the unmasked
    kernel, the non-finite flags equal ``torch.isfinite`` of the output
    and the plain version's flags: on a ragged leaf (bf16, f32) and the
    4-layer stacked leaf (bf16), timed there with the flags written and
    with one chain skipped; then the W-Icon read over heads that differ a
    chain on the stacked leaf, against its plain version and each chain
    alone, timed."""
    from repro_torch.kernels import rng

    gen = torch.Generator(device="cuda").manual_seed(19)
    C, skip = 4, np.array([False, True, False, True])
    out = {}
    for n, dtype in ((RAGGED, torch.bfloat16), (RAGGED, torch.float32),
                     (STACK4_LEAF, torch.bfloat16)):
        x = (torch.randn(C, n, generator=gen, device="cuda") * 0.02).to(dtype)
        g = (torch.randn(C, n, generator=gen, device="cuda") * 1e-2).to(dtype)
        g[1].fill_(float("nan"))
        g[3, :7] = float("nan")
        g[2, n // 3] = float("inf")
        seeds = rng.split((n, 5), C)
        gammas = np.full(C, 1e-3, np.float32)
        scales = np.full(C, np.sqrt(np.float32(2e-5) * np.float32(1e-3)), np.float32)
        full = _device_table(torch, np, lu.chain_rows(seeds, gammas, scales))
        masked = _device_table(torch, np, lu.chain_rows(seeds, gammas, scales, skip))
        plain = lu.langevin_update(x.clone(), g, full)
        flags = torch.zeros(C, dtype=torch.int32, device="cuda")
        got = lu.langevin_update(x.clone(), g, masked, flags)
        torch.cuda.synchronize()
        name = f"{n}_{str(dtype).replace('torch.', '')}"
        check(all(bitwise_equal(torch, got[c], x[c] if skip[c] else plain[c])
                  for c in range(C)),
              f"langevin_update skip {name}: a skipped row moved, or a kept row is "
              "not the unmasked kernel's")
        finite = (~torch.isfinite(got).all(dim=1)).to(torch.int32)
        check(flags.tolist() == finite.tolist() == [0, 0, 1, 0],
              f"langevin_update flags {name}: {flags.tolist()}, isfinite says "
              f"{finite.tolist()}")
        if n == RAGGED:
            want_flags = torch.zeros(C, dtype=torch.int32)
            want = ref.langevin_update_ref(x.clone(), g, seeds, gammas, scales, skip,
                                           want_flags)
            check(want_flags.tolist() == flags.tolist(),
                  f"langevin_update flags {name}: plain version's {want_flags.tolist()}")
            keep = torch.from_numpy(~skip).to("cuda")
            err = (got[keep].float() - want[keep].float()).nan_to_num(0, 0, 0).abs().max().item()
            check(err <= 2e-6 if dtype == torch.float32 else within_bf16_ulp(
                torch, got[keep].nan_to_num(0), want[keep].nan_to_num(0)),
                f"langevin_update skip {name}: max |err| {err} against the plain version")
            del want
        else:
            g[1].zero_()
            g[3].zero_()
            g[2].zero_()
            out = {"leaf": "stack4", "chains": C, "n": n,
                   "ms": cuda_ms(torch, [lambda: lu.langevin_update(x, g, full)], 10),
                   "flags_ms": cuda_ms(torch, [lambda: lu.langevin_update(
                       x, g, full, flags)], 10),
                   "one_skipped_ms": cuda_ms(torch, [lambda: lu.langevin_update(
                       x, g, _device_table(torch, np, lu.chain_rows(
                           seeds, gammas, scales, [False, True, False, False])))], 10)}
        del x, g, plain, got
        torch.cuda.empty_cache()
    n, maxvals, heads = STACK4_LEAF, [3, 3, 2, 1], [2, 1, 2, 0]
    h = torch.randn(C, 3, n, generator=gen, device="cuda").to(torch.bfloat16)
    keys = rng.split((C, n + 3), C)
    table = _device_table(torch, np, dg.randint_rows(keys, maxvals, heads))
    got = dg.wicon_read(h, table, maxvals, heads)
    check(bitwise_equal(torch, got, ref.wicon_read_ref(h, keys, maxvals, heads))
          and all(bitwise_equal(torch, got[c], dg.wicon_read(
              h[c:c + 1].clone(), draw_table(torch, np, dg, keys[c], maxvals[c], heads[c]),
              [maxvals[c]], [heads[c]])[0]) for c in range(C)),
          "wicon_read stack4, a head a chain: not bit for bit")
    out["read_mixed_heads_ms"] = cuda_ms(torch, [lambda: dg.wicon_read(
        h, table, maxvals, heads)], 10)
    del h, got
    torch.cuda.empty_cache()
    log("masked-commit kernels: skipped rows untouched, kept rows == the unmasked "
        "kernel, flags == torch.isfinite == the plain flags (ragged bf16/f32, stack4); "
        "the read over a head a chain == plain and each chain alone", json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 3: kernel path == plain path, end to end, on a small f32 bank
# ---------------------------------------------------------------------------
def reference_check(torch, np) -> None:
    from repro_torch.cluster import DecodeEngine, PagedDecodeEngine, Request
    from repro_torch.configs import get_reduced
    from repro_torch.models.transformer import init_params
    from repro_torch.utils import tree_map

    cfg = replace(get_reduced("qwen3-4b"), dtype="float32")
    cpu = init_params(cfg, torch.Generator().manual_seed(3), device="cpu",
                      num_chains=4)
    gpu = tree_map(lambda t: t.to("cuda"), cpu)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (3, 7)).astype(np.int32)
    runs = {}
    for dev, bank in (("cpu", cpu), ("cuda", gpu)):
        eng = DecodeEngine(cfg, bank, max_seq=32, return_logits=True, device=dev)
        runs[dev] = eng.generate(toks, 8)
    check(np.array_equal(runs["cpu"].tokens, runs["cuda"].tokens),
          "small bank: DecodeEngine tokens differ between card and CPU")
    err = float(np.abs(runs["cpu"].logits - runs["cuda"].logits).max())
    check(err <= 1e-4, f"small bank: DecodeEngine log-probs differ by {err}")
    log(f"reference DecodeEngine: card == CPU, tokens equal, max |dlogp| {err:.3g}")
    lens, budgets = [5, 9, 3, 12, 6], [7, 6, 9, 5, 8]
    prompts = [rng.integers(0, cfg.vocab_size, (t,)).astype(np.int32) for t in lens]
    out = {}
    for dev, bank in (("cpu", cpu), ("cuda", gpu)):
        eng = PagedDecodeEngine(cfg, bank, num_slots=3, page_size=8,
                                max_seq=32, decode_chunk=3, return_logits=True,
                                device=dev)
        ids, early = [], []
        for i, (p, n) in enumerate(zip(prompts, budgets)):
            if i == 3:
                early = eng.step()  # fill the slots: the priority one preempts
            ids.append(eng.submit(Request(tokens=p, max_new_tokens=n,
                                          priority=2 if i == 4 else 0,
                                          key=None if i % 2 else 100 + i)))
        done = {c.request_id: c for c in early + eng.drain()}
        out[dev] = [done[i] for i in ids]
    worst = 0.0
    for a, b in zip(out["cpu"], out["cuda"]):
        check(np.array_equal(a.tokens, b.tokens),
              "small bank: PagedDecodeEngine tokens differ between card and CPU")
        worst = max(worst, float(np.abs(a.logits - b.logits).max()))
    check(worst <= 1e-4, f"small bank: paged log-probs differ by {worst}")
    ev = sum(c.timing.get("evictions", 0) for c in out["cuda"])
    check(ev >= 1, "small bank: the priority request preempted nothing")
    log(f"reference PagedDecodeEngine: card == CPU, tokens equal, "
        f"max |dlogp| {worst:.3g}, evictions {ev}")


def training_reference_check(torch, np, lu, dg, cfg=None) -> dict:
    """4 fused W-Icon commits of a reduced float32 model (qwen3-4b's unless
    ``cfg``) on the card (kernels) and on the CPU (plain path), from the
    same weights, batches, delays and keys."""
    from repro_torch import samplers
    from repro_torch.configs import get_reduced
    from repro_torch.core import WorkerModel, simulate_async
    from repro_torch.kernels import rng
    from repro_torch.models.transformer import Model, init_params
    from repro_torch.train.engine import Engine
    from repro_torch.train.loop import make_grad_fn
    from repro_torch.utils import tree_leaves, tree_map

    cfg = cfg or replace(get_reduced("qwen3-4b"), dtype="float32")
    cpu = init_params(cfg, torch.Generator().manual_seed(4), device="cpu",
                      num_chains=1)
    n_leaves = len(tree_leaves(cpu))
    gpu = tree_map(lambda t: t.to("cuda"), cpu)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (4, 4, 33))
    delays = np.minimum(simulate_async(WorkerModel(num_workers=8), 4).delays, 2)
    out = {}
    for dev, params in (("cpu", cpu), ("cuda", gpu)):
        s = samplers.sgld("inconsistent", make_grad_fn(Model(cfg, device=dev)),
                          gamma=1e-3, sigma=0.5, tau=2, has_aux=True, fused=True)
        counters = (lu.langevin_update, dg.wicon_read, dg.delay_gather,
                    dg.coordinate_delays)
        n0 = [c.launches for c in counters]
        state, aux = Engine(s, chunk_size=2).run(
            s.init(params, rng.PRNGKey(4)), steps=4,
            batches={"tokens": tokens.astype(np.int32)}, delays=delays)
        out[dev] = (aux["loss"], [t.cpu() for t in tree_leaves(state.params)])
        ran = tuple(c.launches - n for c, n in zip(counters, n0))
        check(ran == ((0, 0, 0, 0) if dev == "cpu" else (n_leaves * 4, n_leaves * 4, 0, 0)),
              f"training on {dev}: kernel launches {ran} (update, W-Icon read, "
              "gather, draw)")
        if dev == "cuda":
            launches = dict(zip(("langevin_update", "wicon_read", "delay_gather",
                                 "coordinate_delays"), ran))
    (lc, pc), (lg, pg) = out["cpu"], out["cuda"]
    loss_err = float(np.abs(lg / lc - 1).max())
    check(loss_err <= 1e-5, f"reduced training: losses differ, rel {loss_err}")
    p_err = max(float((a - b).abs().max()) for a, b in zip(pc, pg))
    check(p_err <= 1e-5, f"reduced training: parameters differ by {p_err}")
    log(f"reference training {cfg.name} (fused W-Icon, 4 commits): card == CPU, "
        f"losses {np.round(lg, 4).tolist()} within rel {loss_err:.3g}, "
        f"parameters within {p_err:.3g}")
    return {"launches": launches, "loss_rel_err": loss_err, "param_max_abs_err": p_err}


# ---------------------------------------------------------------------------
# phase 7: the paper path — the §3.2 regression and §3.3 RICA experiments
# ---------------------------------------------------------------------------
def _counts(kernels) -> dict:
    return {name: k.launches for name, k in kernels.items()}


def _reset(kernels) -> None:
    for k in kernels.values():
        k.launches = 0


def paper_reference_check(np, kernels) -> None:
    """(a) Both experiments at sigma = 0 (regression P 4, 400 steps; RICA
    patch 16, 8 features, 60 steps), all three modes, on the card and on
    the CPU: the same iterations, simulated times and speedups, and
    trajectories, W2, objectives and distances within PAPER_RTOL /
    PAPER_ATOL.  The card's W-Icon draws its coordinate delays with the
    delay kernel and gathers with the gather kernel, one launch each a
    commit; the CPU launches nothing."""
    from repro_torch.experiments import run_regression_experiment, run_rica_experiment

    runs, worst = {}, {}
    for name, fn, kw, n_icon in (
            ("regression", run_regression_experiment,
             dict(P=4, steps=400, sigma=0.0), 400),
            ("rica", run_rica_experiment,
             dict(patch_dim=16, num_features=8, steps=60, nu=0.0), 60)):
        for dev in ("cpu", "cuda"):
            _reset(kernels)
            runs[dev] = fn(**kw, device=dev)
            want = dict.fromkeys(kernels, 0)
            if dev == "cuda":
                want["coordinate_delays"] = want["delay_gather"] = n_icon
            check(_counts(kernels) == want, f"paper {name} at sigma 0 on {dev}: "
                  f"launches {_counts(kernels)}, want {want}")
        fields = ("traj2d", "w2") if name == "regression" else ("objective", "dist_to_opt")
        for mode in MODES:
            c, g = runs["cpu"][mode], runs["cuda"][mode]
            check(np.array_equal(c.iters, g.iters) and np.array_equal(c.times, g.times)
                  and c.speedup == g.speedup,
                  f"paper {name} {mode}: iterations, times or speedup differ")
            for f in fields:
                a, b = np.asarray(getattr(c, f)), np.asarray(getattr(g, f))
                check(a.shape == b.shape and np.isfinite(b).all(),
                      f"paper {name} {mode} {f}: shape {b.shape} or non-finite")
                check(np.allclose(b, a, rtol=PAPER_RTOL, atol=PAPER_ATOL),
                      f"paper {name} {mode} {f}: card and CPU differ by "
                      f"{np.abs(b - a).max()}")
                worst[f] = max(worst.get(f, 0.0), float(np.abs(b - a).max()))
    log(f"paper path (a), sigma 0, card == CPU: max |diff| "
        f"{ {k: float(f'{v:.3g}') for k, v in worst.items()} } "
        f"(limit {PAPER_ATOL} + {PAPER_RTOL} x |CPU|)")


def paper_fused_check(np, kernels) -> dict:
    """(b) The regression chain through the preset's fused commit at the
    published gamma and sigma, W-Con and W-Icon, 400 commits, on the card
    (the Langevin-update kernel, and for W-Icon the one-pass read) and on
    the CPU (their plain versions): the same noise bits, so the
    trajectories agree within PAPER_RTOL / PAPER_ATOL; every iterate
    differs from the one before (``Sampler.run`` copies each iterate
    out of the in-place commit)."""
    from repro_torch import samplers
    from repro_torch.core import PolyRegression, WorkerModel, simulate_async
    from repro_torch.kernels import rng

    n, s = 400, PUBLISHED["regression"]
    delays = np.minimum(simulate_async(WorkerModel(num_workers=s["P"]), n).delays,
                        s["tau_cap"])
    out = {}
    _reset(kernels)
    for mode in ("consistent", "inconsistent"):
        traj = {}
        for dev in ("cpu", "cuda"):
            reg = PolyRegression.make(rng.PRNGKey(0), nu_std=s["nu"], device=dev)
            mu = reg.posterior_moments(sigma=s["sigma"])[0]
            sampler = samplers.sgld(
                mode, lambda p, k, reg=reg: reg.grad(p, reg.sample_batch(k, s["batch"])),
                gamma=s["gamma"], sigma=s["sigma"], tau=s["tau_cap"], fused=True)
            _, traj[dev] = sampler.run(sampler.init(mu + 1.0, rng.PRNGKey(1)),
                                       rng.split(rng.PRNGKey(2), n), delays)
        a, b = traj["cpu"].numpy(), traj["cuda"].cpu().numpy()
        err = float(np.abs(a - b).max())
        check(np.isfinite(b).all() and np.allclose(b, a, rtol=PAPER_RTOL, atol=PAPER_ATOL),
              f"paper fused {mode}: card and CPU trajectories differ by {err}")
        check(bool((np.abs(np.diff(b, axis=0)).max(axis=1) > 0).all()),
              f"paper fused {mode}: two consecutive iterates are equal")
        out[mode] = err
    got = _counts(kernels)
    want = {"langevin_update": 2 * n, "wicon_read": n, "delay_gather": 0,
            "coordinate_delays": 0}
    check(got == want, f"paper fused: launches {got}, want {want}")
    log(f"paper path (b), fused preset at gamma {s['gamma']} sigma {s['sigma']}, "
        f"{n} commits: card == CPU within {out}; launches {got}")
    return {"max_abs_err": out, "launches": got}


def paper_path(torch, np, kernels) -> dict:
    """(c) Both experiments at their published settings on the card, each
    mode in its own call: the final W2 (regression) or objective and
    distance (RICA) within the fixture's band around the JAX package's
    value, the speedup equal to it; wall seconds, commits a second, and
    the delay kernels' launches a commit."""
    from repro_torch.experiments import run_regression_experiment, run_rica_experiment

    fx = json.loads(REFERENCE.read_text())
    out, launches = {}, dict.fromkeys(kernels, 0)
    for name, fn in (("regression", run_regression_experiment),
                     ("rica", run_rica_experiment)):
        s = PUBLISHED[name]
        check(fx["settings"][name] == s, f"{REFERENCE.name}: {name} settings differ")
        kw = {k: v for k, v in s.items() if k != "modes"}
        out[name] = {}
        for mode in s["modes"]:
            _reset(kernels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(**kw, modes=(mode,), device="cuda")[mode]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = _counts(kernels)
            for k, v in got.items():
                launches[k] += v
            n = max(s["steps"] // s["P"], 1) if mode == "sync" else s["steps"]
            # RICA runs its optimum's plain-SGD chain (2 x steps) in each call
            commits = n + (2 * s["steps"] if name == "rica" else 0)
            icon = n if mode == "inconsistent" else 0
            check(got["coordinate_delays"] == got["delay_gather"] == icon
                  and got["langevin_update"] == got["wicon_read"] == 0,
                  f"paper {name} {mode}: launches {got}")
            ref, band = fx["reference"][name][mode], fx["band"][name][mode]
            vals = ({"w2": float(res.w2[-1])} if name == "regression" else
                    {"objective": float(res.objective[-1]),
                     "dist_to_opt": float(res.dist_to_opt[-1])})
            for k, v in vals.items():
                dev = abs(math.log(v / ref[k])) if v > 0 else math.inf
                check(math.isfinite(v) and dev <= band[k],
                      f"paper {name} {mode}: final {k} {v} outside the band "
                      f"|ln(v / {ref[k]})| <= {band[k]:.4g} ({dev:.4g})")
            check(res.speedup == ref["speedup"],
                  f"paper {name} {mode}: speedup {res.speedup} != {ref['speedup']}")
            row = {**vals, "reference": {k: ref[k] for k in vals}, "band": band,
                   "speedup": res.speedup, "wall_s": wall, "commits": commits,
                   "commits_per_s": commits / wall,
                   "kernel_launches_per_commit": {k: v / commits for k, v in got.items() if v}}
            out[name][mode] = row
            log(f"paper path (c), {name} {mode}: "
                + ", ".join(f"final {k} {v:.6g} (JAX {ref[k]:.6g}, "
                            f"|ln ratio| {abs(math.log(v / ref[k])):.3g} <= {band[k]:.3g})"
                            for k, v in vals.items())
                + f"; speedup {res.speedup:.6g}; {wall:.2f} s, {commits} commits, "
                f"{commits / wall:.1f} commits/s; delay-kernel launches a commit "
                f"{got['coordinate_delays'] / commits:.3g}")
    check(launches["coordinate_delays"] > 0, "paper path: the delay kernel never ran")
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# phases 4-5: the main path at full width
# ---------------------------------------------------------------------------
def main_path(torch, np, ds, cfg, device="cuda") -> dict:
    from repro_torch.cluster import DecodeEngine, PagedDecodeEngine, Request
    from repro_torch.models.predictive import bma_logits
    from repro_torch.models.transformer import Model, init_params
    from repro_torch.obs.metrics import registry
    from repro_torch.utils import tree_leaves

    C, L, V = 4, cfg.num_layers, cfg.vocab_size
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device=device, num_chains=C)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    log(f"bank: {C} x {cfg.name}, {L} layers, {n_bytes / 1e9:.2f} GB {cfg.dtype}, "
        f"drawn in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, V, (4, 32)).astype(np.int32)
    reg = registry()
    out = {}

    # -- DecodeEngine ---------------------------------------------------------
    eng = DecodeEngine(cfg, params, max_seq=256, return_logits=True,
                       device=device)
    eng.generate(prompts, 2)  # warm-up: cuBLAS handles, allocator
    sync()
    steps0 = reg.counter("decode.steps").value
    ds.decode_step.launches = 0
    ds.paged_decode_step.launches = 0
    t0 = time.perf_counter()
    greedy = eng.generate(prompts, 16)
    t_greedy = time.perf_counter() - t0
    sampled = eng.generate(prompts[:1], 16, key=1234)
    launches = ds.decode_step.launches
    steps = reg.counter("decode.steps").value - steps0
    steps = int(steps)
    check(steps == 2 * 15, f"decode steps {steps}")
    check(launches == L * steps,
          f"decode kernel launched {launches} times for {steps} steps x {L} layers")
    check(ds.paged_decode_step.launches == 0, "paged kernel ran in DecodeEngine")
    for res, b in ((greedy, 4), (sampled, 1)):
        check(res.tokens.shape == (b, 16), f"tokens shape {res.tokens.shape}")
        check(((res.tokens >= 0) & (res.tokens < V)).all(), "token outside vocab")
        check(res.logits.shape == (b, 16, V), f"logits shape {res.logits.shape}")
        check(np.isfinite(res.logits).all(), "non-finite BMA log-probs")
        check(np.allclose(np.exp(res.logits).sum(-1), 1.0, atol=1e-3),
              "BMA log-probs are not a distribution")
    check(np.array_equal(greedy.tokens, np.argmax(greedy.logits, -1)),
          "greedy tokens are not the argmax of the BMA law")
    # decode vs one prefill over the generated stream (bf16: reported)
    stream = np.concatenate([prompts, greedy.tokens[:, :-1]], axis=1)
    with torch.no_grad():
        full, _, _ = Model(cfg, device).forward(params, {"tokens": stream})
        ref_logp = bma_logits(full[:, :, 31:]).cpu().numpy()
    del full
    dev = float(np.abs(ref_logp - greedy.logits).max())
    per_tok = t_greedy * 1e3 / 16
    log(f"DecodeEngine: 4 x (32 + 16) greedy in {t_greedy:.3f} s "
        f"({per_tok:.2f} ms/token, {4 * 16 / t_greedy:.1f} tokens/s); "
        f"sampled request ok; decode kernel launches {launches} = {L} x {steps}; "
        f"max |logp(decode) - logp(prefill)| {dev:.3g} (bf16)")
    out["decode"] = {"launches": launches, "steps": steps, "per_token_ms": per_tok,
                     "decode_vs_prefill_max_abs": dev}
    del eng

    # -- PagedDecodeEngine ----------------------------------------------------
    peng = PagedDecodeEngine(cfg, params, num_slots=8, page_size=16,
                             max_seq=256, decode_chunk=8, device=device)
    lens = [8, 96, 17, 64, 33, 8, 80, 45, 12, 96, 24, 50]
    budgets = [32, 4, 16, 24, 8, 32, 12, 4, 20, 16, 28, 6]
    prio = [0] * 10 + [1, 1]
    reqs = [rng.integers(0, V, (t,)).astype(np.int32) for t in lens]
    micro0 = reg.counter("paged.micro_steps").value
    ds.decode_step.launches = 0
    ds.paged_decode_step.launches = 0
    t0 = time.perf_counter()
    ids, early = [], []
    for i, (p, n, pr) in enumerate(zip(reqs, budgets, prio)):
        if i == 10:
            early = peng.step()  # slots full: the priority requests preempt
        ids.append(peng.submit(Request(tokens=p, max_new_tokens=n, priority=pr,
                                       key=None if i % 3 else 77 + i)))
    done = {c.request_id: c for c in early + peng.drain()}
    t_paged = time.perf_counter() - t0
    launches = ds.paged_decode_step.launches
    micro = int(reg.counter("paged.micro_steps").value - micro0)
    comps = [done[i] for i in ids]
    for c, n in zip(comps, budgets):
        check(c.status == "ok" and len(c.tokens) == n,
              f"request {c.request_id}: {c.status}, {len(c.tokens)} of {n}")
        check(((c.tokens >= 0) & (c.tokens < V)).all(), "token outside vocab")
    check(launches == L * micro,
          f"paged kernel launched {launches} times for {micro} micro-steps x {L}")
    check(ds.decode_step.launches == 0, "ring kernel ran in PagedDecodeEngine")
    check(peng.free_pages == peng.num_pages - 1 and peng.num_active == 0,
          "pages still held after drain")
    evictions = sum(c.timing.get("evictions", 0) for c in comps)
    check(evictions >= 1, "the priority requests preempted nothing")
    n_tok = sum(len(c.tokens) for c in comps)
    log(f"PagedDecodeEngine: 12 requests, {n_tok} tokens in {t_paged:.3f} s "
        f"({n_tok / t_paged:.1f} tokens/s), {micro} micro-steps, "
        f"{evictions} evictions; paged kernel launches {launches} = {L} x {micro}")
    out["paged"] = {"launches": launches, "micro_steps": micro,
                    "tokens_per_s": n_tok / t_paged, "evictions": evictions}
    del peng
    gc.collect()
    torch.cuda.empty_cache()
    out["serve"] = serve_path(torch, np, ds, cfg, params, prompts, greedy.tokens)
    return out


def serve_path(torch, np, ds, cfg, params, prompts, greedy) -> dict:
    """The main path, part 2b: ``ServeEngine`` on the same 4-chain bank —
    (a) ``transformer_next_token_predict`` over 8 prompts of 1,024 tokens
    (the long-prompt SDPA path): the mean within rtol 1e-6 of the chain
    average of the per-chain predictions computed here, ordered quantiles,
    everything finite; (b) a mixed stream of 3, 5, 8 and 3 queries of 128
    tokens: no host pad scratch is made once rungs 4 and 8 have been seen;
    (c) one 8,192-token query (naive attention would need 34.4 GB of scores
    a layer); (d) ``serve.decoder(model)`` greedy-decodes the
    ``DecodeEngine`` section's tokens.  No decode kernel runs in (a)-(c);
    in (d) the ring kernel runs once a layer a step."""
    from repro_torch.cluster import ServeEngine
    from repro_torch.models import transformer_next_token_predict
    from repro_torch.models.transformer import Model
    from repro_torch.utils import tree_leaves

    V, L = cfg.vocab_size, cfg.num_layers
    dev = tree_leaves(params)[0].device
    model = Model(cfg, device=dev)
    predict = transformer_next_token_predict(model)
    serve = ServeEngine(predict_fn=predict, params=params, device=dev)
    rng = np.random.default_rng(8)
    out = {}

    def finite(res, q):
        return (res.mean.shape == (q, V) and res.quantiles.shape == (3, q, V)
                and all(np.isfinite(x).all() for x in res))

    # (a) 8 prompts of 1,024 tokens
    long = rng.integers(0, V, (8, 1024)).astype(np.int32)
    serve({"tokens": long[:1]})  # warm-up: the SDPA backend, allocator
    ds.decode_step.launches = ds.paged_decode_step.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = serve({"tokens": long})
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    with torch.no_grad():
        per_chain = predict(params, {"tokens": torch.from_numpy(long).to(dev)})
    want = per_chain.mean(dim=0).cpu().numpy()
    del per_chain
    check(finite(res, 8), "serve (a): statistics not finite or misshapen")
    check(np.allclose(res.mean, want, rtol=1e-6),
          f"serve (a): mean differs from the chain average by "
          f"{np.abs(res.mean - want).max()}")
    check(bool((res.quantiles[0] <= res.quantiles[1]).all()
               and (res.quantiles[1] <= res.quantiles[2]).all()),
          "serve (a): quantiles out of order")
    out["long"] = {"queries": 8, "tokens": 1024, "ms_per_request": ms,
                   "queries_per_s": 8e3 / ms, "peak_gb": peak,
                   "mean_vs_chain_average_max_abs": float(np.abs(res.mean - want).max())}
    log(f"serve (a): 8 x 1024-token prompts over {serve.num_chains} chains in {ms:.1f} ms "
        f"({8e3 / ms:.2f} queries/s), peak {peak:.2f} GB; mean == chain average "
        f"within {out['long']['mean_vs_chain_average_max_abs']:.3g}, quantiles ordered")

    # (b) a mixed stream at 128 tokens: one host scratch a rung
    allocs, t_b = [], []
    for q in (3, 5, 8, 3):
        t0 = time.perf_counter()
        r = serve({"tokens": rng.integers(0, V, (q, 128)).astype(np.int32)})
        t_b.append((time.perf_counter() - t0) * 1e3)
        check(finite(r, q), f"serve (b): {q} queries not finite or misshapen")
        allocs.append(serve.num_host_pad_allocs)
    check(allocs[1:] == [allocs[1]] * 3,
          f"serve (b): host pad scratch grew after rungs 4 and 8: {allocs}")
    out["mixed"] = {"sizes": [3, 5, 8, 3], "pad_allocs": allocs, "ms": t_b}
    log(f"serve (b): stream 3, 5, 8, 3 x 128 tokens in "
        f"{', '.join(f'{t:.1f}' for t in t_b)} ms; host pad scratch {allocs}")

    # (c) one 8,192-token query on the long path
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r = serve({"tokens": rng.integers(0, V, (1, 8192)).astype(np.int32)})
    ms_c = (time.perf_counter() - t0) * 1e3
    peak_c = torch.cuda.max_memory_allocated() / 1e9
    check(finite(r, 1), "serve (c): the 8,192-token query is not finite")
    check(ds.decode_step.launches == ds.paged_decode_step.launches == 0,
          "serve (a)-(c): a decode kernel ran on the predictive path")
    out["prompt_8192"] = {"ms": ms_c, "peak_gb": peak_c}
    log(f"serve (c): one 8,192-token query in {ms_c:.1f} ms, peak {peak_c:.2f} GB "
        f"(the bank {sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 1e9:.2f} "
        f"GB; naive fp32 scores would take "
        f"{serve.num_chains * cfg.num_heads * 8192**2 * 4 / 1e9:.1f} GB a layer)")

    # (d) the decoder over the same bank: the DecodeEngine section's tokens
    ds.decode_step.launches = 0
    tokens = serve.decoder(cfg).generate(prompts, 16).tokens
    launches = ds.decode_step.launches
    check(np.array_equal(tokens, greedy),
          f"serve (d): decoder tokens {tokens.tolist()} != DecodeEngine's {greedy.tolist()}")
    check(launches == L * 15, f"serve (d): decode kernel launched {launches} times, "
          f"want {L} x 15")
    out["decoder"] = {"launches": launches, "tokens_equal": True}
    log(f"serve (d): ServeEngine.decoder greedy tokens == DecodeEngine's; decode "
        f"kernel launches {launches} = {L} x 15")
    return out


# ---------------------------------------------------------------------------
# phase 6: the main path, part 3 — training at full width
# ---------------------------------------------------------------------------
def train_path(torch, np, lu, dg, arch_args=("--arch", "qwen3-4b", "--seq", "128"),
               cut=None) -> dict:
    """The launcher's path (``repro_torch.launch.train``): ``--mode
    inconsistent --fused --tau 2 --batch 8``, 6 commits in chunks of 3,
    with ``arch_args`` naming the architecture, its sequence, any step size
    and any depth cut (``cut`` says which, for the log).  An MoE
    architecture's aux (its load-balance loss) must be positive on every
    commit."""
    from repro_torch.launch import train as launch
    from repro_torch.utils import tree_leaves

    steps, chunk = 6, 3
    args = launch.parser().parse_args(
        [*arch_args, "--mode", "inconsistent", "--fused", "--tau", "2",
         "--batch", "8", "--steps", str(steps), "--chunk", str(chunk)])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, model, state, engine, delays = launch.build(args)
    torch.cuda.synchronize()
    leaves = tree_leaves(state.params)
    n_params = sum(t.numel() for t in leaves)
    log(f"training: 1 x {cfg.name}{f' ({cut})' if cut else ''}, "
        f"{n_params / 1e9:.3f} B parameters in "
        f"{len(leaves)} leaves, {sum(t.numel() * t.element_size() for t in leaves) / 1e9:.2f} GB; "
        f"ring of {args.tau + 1}; built in {time.perf_counter() - t0:.1f} s; "
        f"delays {delays.tolist()}")
    ends = []

    def timer(_step_end, _state, _aux):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())

    engine.hooks = [*engine.hooks, timer]
    counters = {"langevin_update": lu.langevin_update, "wicon_read": dg.wicon_read,
                "delay_gather": dg.delay_gather,
                "coordinate_delays": dg.coordinate_delays}
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    state, aux = engine.run(state, steps=steps, delays=delays, key=args.seed)
    launches = {name: c.launches for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    losses = aux["loss"]
    check(losses.shape == (steps,) and np.isfinite(losses).all(),
          f"training losses {losses}")
    if cfg.num_experts:
        check(bool((aux["aux"] > 0).all()), f"{cfg.name}: router aux {aux['aux']}")
    check(all(bool(torch.isfinite(t).all()) for t in tree_leaves(state.params)),
          "non-finite parameters after training")
    # the W-Icon read draws its delays in the kernel: no standalone gather
    # or draw on the path
    want = {"langevin_update": len(leaves) * steps, "wicon_read": len(leaves) * steps,
            "delay_gather": 0, "coordinate_delays": 0}
    check(launches == want, f"launches {launches} for {steps} commits x "
          f"{len(leaves)} leaves, want {want}")
    first, rest = ends[0] - t0, ends[-1] - ends[0]
    ms = rest * 1e3 / (steps - chunk)
    tok_s = (steps - chunk) * args.batch * args.seq / rest
    log(f"training: {steps} fused W-Icon commits; first chunk {first:.3f} s, "
        f"then {ms:.2f} ms/commit, {tok_s:.1f} tokens/s; losses "
        f"{[round(float(v), 4) for v in losses]}; aux "
        f"{[round(float(v), 4) for v in aux['aux']]}; peak memory {peak / 1e9:.2f} GB; "
        f"launches {launches}")
    return {"arch": cfg.name, "reduced": cut, "params_b": n_params / 1e9,
            "leaves": len(leaves), "batch": args.batch, "gamma": args.gamma,
            "launches": launches, "ms_per_commit": ms, "tokens_per_s": tok_s,
            "first_chunk_s": first, "peak_gb": peak / 1e9,
            "losses": [float(v) for v in losses],
            "aux": [float(v) for v in aux["aux"]]}


def train_lm_decode(torch, np, ds) -> dict:
    """(6b) The torch twin of ``examples/train_lm.py`` at 4 commits of 2 x
    64 tokens, then its greedy decode of 8 tokens through ``DecodeEngine``:
    the ring kernel at a group of 3 (12 query heads over 4 KV heads), once
    a layer a decode step."""
    sys.path.insert(0, str(ROOT / "examples"))
    import torch_train_lm as lm

    ds.decode_step.launches = ds.paged_decode_step.launches = 0
    t0 = time.perf_counter()
    losses, sampled = lm.main(["--steps", "4", "--batch", "2", "--seq", "64",
                               "--device", "cuda"])
    wall = time.perf_counter() - t0
    launches, L = ds.decode_step.launches, lm.LM_100M.num_layers
    check(np.isfinite(losses).all(), f"train_lm: losses {losses}")
    check(len(sampled) == 8 and all(0 <= t < lm.LM_100M.vocab_size for t in sampled),
          f"train_lm: greedy decode {sampled}")
    check(launches == L * 7 and ds.paged_decode_step.launches == 0,
          f"train_lm: decode kernel launched {launches} times, want {L} x 7")
    log(f"train_lm twin: 4 commits and 8 greedy tokens through DecodeEngine in "
        f"{wall:.1f} s; decode kernel (group 3) launches {launches} = {L} x 7")
    return {"launches": launches, "tokens": sampled, "wall_s": wall}


# ---------------------------------------------------------------------------
# phase 8: the main path, part 5 — the multi-chain ClusterEngine
# ---------------------------------------------------------------------------
def cluster_reference_check(torch, np, kernels) -> dict:
    """(a) 8 chains x 37 commits of a d=4 quadratic, fused W-Icon at sigma
    0.5, tau 8, on the card and on the CPU: the same noise bits and
    delays, so the chains agree within PAPER_ATOL + PAPER_RTOL x |CPU|;
    chain c on the card equals the card's single-chain Engine bit for bit;
    the update and the read run once a commit for all chains on the card,
    never on the CPU."""
    from repro_torch import samplers
    from repro_torch.cluster import ClusterEngine, ensemble_async
    from repro_torch.core import Quadratic, WorkerModel
    from repro_torch.kernels import rng
    from repro_torch.train.engine import Engine

    C, steps, tau = 8, 37, 8
    schedules = ensemble_async(WorkerModel(num_workers=4, seed=1), steps, C, seed=0)
    out = {}
    for dev in ("cpu", "cuda"):
        quad = Quadratic.make(rng.PRNGKey(0), d=4, m=1.0, L=3.0, device=dev)
        sampler = samplers.sgld("inconsistent", lambda p, b, q=quad: q.grad(p, b),
                                gamma=0.01, sigma=0.5, tau=tau, fused=True)
        engine = ClusterEngine(sampler, num_chains=C, chunk_size=10)
        state = engine.init(torch.zeros(4, device=dev), rng.PRNGKey(42))
        _reset(kernels)
        state, _ = engine.run(state, steps=steps, schedule=schedules)
        want = dict.fromkeys(kernels, 0)
        if dev == "cuda":
            want.update(langevin_update=steps, wicon_read=steps)
        check(_counts(kernels) == want,
              f"cluster (a) on {dev}: launches {_counts(kernels)}, want {want}")
        out[dev] = state.params.cpu().numpy()
    a, b = out["cpu"], out["cuda"]
    err = float(np.abs(a - b).max())
    check(np.isfinite(b).all() and np.allclose(b, a, rtol=PAPER_RTOL, atol=PAPER_ATOL),
          f"cluster (a): card and CPU chains differ by {err}")
    for c, k in enumerate(rng.split(rng.PRNGKey(42), C)):
        st, _ = Engine(sampler, chunk_size=10).run(
            sampler.init(torch.zeros(4, device="cuda"), k), steps=steps,
            batches=torch.zeros(steps, 1), delays=schedules[c].to_trace())
        check(np.array_equal(st.params.cpu().numpy(), b[c]),
              f"cluster (a): chain {c} differs from the single-chain Engine")
    log(f"cluster (a): {C} chains x {steps} fused W-Icon commits, card == CPU "
        f"within {err:.3g}; every chain == the single-chain Engine bit for bit")
    return {"max_abs_err": err}


def cluster_quickstart(torch, np, kernels) -> dict:
    """(b) The torch cluster quickstart's scenario at its own settings:
    sgld, svrg, sghmc, the inverse-speed half, the fused W-Icon preset;
    final W2, wall seconds, commits a second (each run on its own)."""
    sys.path.insert(0, str(ROOT / "examples"))
    import torch_cluster_quickstart as qs

    out = {}
    runs = [(name, lambda name=name: qs.run_ensemble(name, device="cuda"))
            for name in ("sgld", "svrg", "sghmc")]
    runs.append(("inverse-speed", lambda: qs.run_heterogeneous(device="cuda")))
    runs.append(("fused-wicon", lambda: qs.run_ensemble("sgld", device="cuda",
                                                        fused=True)))
    for name, fn in runs:
        _reset(kernels)
        rows, engine, state, wall, _ = fn()
        got = _counts(kernels)
        w2 = [r["w2"] for r in rows]
        check(len(rows) == qs.COMMITS // 50 and all(math.isfinite(v) for v in w2)
              and w2[-1] < 1.0, f"cluster (b) {name}: W2 rows {w2}")
        want = dict.fromkeys(kernels, 0)
        if name == "fused-wicon":
            want.update(langevin_update=qs.COMMITS, wicon_read=qs.COMMITS)
        check(got == want, f"cluster (b) {name}: launches {got}, want {want}")
        out[name] = {"final_w2": w2[-1], "w2": w2, "wall_s": wall,
                     "commits_per_s": qs.COMMITS / wall, "launches": got}
        log(f"cluster (b), {name}: {qs.CHAINS} chains x {qs.COMMITS} commits, final "
            f"W2 {w2[-1]:.4f}, {wall:.2f} s, {qs.COMMITS / wall:.1f} commits/s"
            + (f"; launches {got}" if name == "fused-wicon" else ""))
    return out


def serve_quickstart(torch, np, kernels, ds) -> dict:
    """(d) The torch serve quickstart at its own settings (32 chains, 8
    workers, 4,000 W-Con commits of the polynomial regression, the bank
    saved and restored into a ``ServeEngine``): the served means and 90%
    intervals against the closed-form posterior predictive
    (``torch_serve_quickstart.check``); no kernel of this repo runs
    (unfused W-Con, a predictive path)."""
    sys.path.insert(0, str(ROOT / "examples"))
    import torch_serve_quickstart as sq

    every = {**kernels, "decode_step": ds.decode_step,
             "paged_decode_step": ds.paged_decode_step}
    _reset(every)
    out = sq.run(device="cuda", commits=sq.COMMITS)
    got = _counts(every)
    verdict = sq.check(out)
    check(verdict["ok"], f"serve quickstart: against the closed form {verdict}")
    check(got == dict.fromkeys(every, 0), f"serve quickstart: launches {got}")
    log(f"serve quickstart: {sq.CHAINS} chains x {out['commits']} commits in "
        f"{out['train_s']:.2f} s ({out['commits'] / out['train_s']:.1f} commits/s); "
        f"{sq.QUERIES} queries served in {out['serve_ms']:.2f} ms; against the closed "
        f"form {verdict}")
    return {"commits": out["commits"], "train_s": out["train_s"],
            "serve_ms": out["serve_ms"], "check": verdict}


def cluster_path(torch, np, kernels, keep=()) -> dict:
    """(c) 4 chains of qwen3-4b at its published widths, CLUSTER_LAYERS
    layers, fused W-Icon at tau 2, 3 commits in one chunk.  ``keep``:
    chains whose final parameters come back on the host (phase 9b holds
    its chains against them)."""
    from repro_torch import samplers
    from repro_torch.cluster import ClusterEngine, ensemble_async
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core import WorkerModel
    from repro_torch.data import make_batch
    from repro_torch.kernels import rng
    from repro_torch.models.transformer import Model, init_params
    from repro_torch.train.loop import make_grad_fn
    from repro_torch.utils import tree_leaves

    C, steps, tau = 4, 3, 2
    cfg = replace(get_arch("qwen3-4b"), num_layers=CLUSTER_LAYERS)
    shape = ShapeConfig("cluster", seq_len=128, global_batch=8, kind="train")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda")
    sampler = samplers.sgld("inconsistent", make_grad_fn(model), gamma=1e-3,
                            sigma=1e-5, tau=tau, has_aux=True, fused=True)
    engine = ClusterEngine(sampler, num_chains=C, chunk_size=steps, collect_aux=True,
                           batch_fn=lambda gen: make_batch(cfg, shape, gen, "train"))
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda", num_chains=1)
    state = engine.init(params, rng.PRNGKey(0))
    del params
    torch.cuda.synchronize()
    leaves = tree_leaves(state.params)
    per_chain = sum(t[0].numel() for t in leaves)
    schedules = ensemble_async(WorkerModel(num_workers=8), steps, C, seed=0)
    delays = np.stack([s.delays for s in schedules], axis=1)
    log(f"cluster (c): {C} x {cfg.name} at {cfg.num_layers} layers, "
        f"{per_chain / 1e9:.3f} B parameters a chain in {len(leaves)} leaves, "
        f"state {torch.cuda.memory_allocated() / 1e9:.2f} GB, built in "
        f"{time.perf_counter() - t0:.1f} s; delays (commit x chain) {delays.tolist()}")
    _reset(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, aux = engine.run(state, steps=steps, schedule=schedules, key=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = _counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    losses = aux["loss"]
    check(losses.shape == (steps, C) and np.isfinite(losses).all(),
          f"cluster (c): losses {losses}")
    check(all(bool(torch.isfinite(t).all()) for t in leaves),
          "cluster (c): non-finite parameters")
    want = dict.fromkeys(kernels, 0)
    want.update(langevin_update=len(leaves) * steps, wicon_read=len(leaves) * steps)
    check(got == want, f"cluster (c): launches {got}, want {want} "
          f"({len(leaves)} leaves x {steps} commits, whatever C)")
    ms = wall * 1e3 / steps
    log(f"cluster (c): {steps} fused W-Icon commits of {C} chains in {wall:.3f} s, "
        f"{ms:.2f} ms a commit ({ms / C:.2f} a chain-commit), "
        f"{steps * C * 8 * 128 / wall:.1f} tokens/s; losses "
        f"{np.round(losses, 4).tolist()}; peak memory {peak / 1e9:.2f} GB; "
        f"launches {got}")
    return {"launches": got, "ms_per_commit": ms, "wall_s": wall, "peak_gb": peak / 1e9,
            "chains": C, "layers": cfg.num_layers,
            "losses": losses.tolist(),
            "final": {c: [t[c].cpu() for t in leaves] for c in keep}}


# ---------------------------------------------------------------------------
# phase 9: the main path, part 6 — faults, checkpoints and self-healing
# ---------------------------------------------------------------------------
CHAOS = dict(crash_rate=0.15, mean_downtime=2.0, pause_rate=0.1, mean_pause=1.0)


def _registry_value(name: str) -> float:
    from repro_torch.obs.metrics import registry

    return registry().snapshot().get(name, {}).get("value", 0.0)


def _ckpt_dir():
    """A temporary directory inside the checkout (deleted after use): the
    checkpoints of phase 9 are several GB."""
    import tempfile

    return tempfile.TemporaryDirectory(prefix="_ckpt", dir=ROOT)


def cluster_fault_check(torch, np, kernels) -> dict:
    """(a) The ClusterEngine under a FaultPlan chaos schedule, a nan_storm
    and health_check with respawn: 8 chains x 40 commits of the d=4
    quadratic, tau 32, fused W-Icon and fused W-Con, on the card and on the
    CPU: iterates within PAPER_ATOL + PAPER_RTOL x |CPU|, health masks at
    every chunk boundary, respawn counts, keys and ring heads equal; the
    update once a commit (and the read once a commit in W-Icon) on the
    card, whatever was masked.  Then the card's W-Icon run interrupted at
    commit 20 and resumed from its run checkpoint is bitwise the
    uninterrupted run."""
    from repro_torch import samplers
    from repro_torch.cluster import ClusterEngine, ensemble_async
    from repro_torch.core import FaultPlan, Quadratic, WorkerModel
    from repro_torch.faults import nan_storm
    from repro_torch.kernels import rng

    C, steps, tau = 8, 40, 32
    scheds = ensemble_async(WorkerModel(num_workers=4, seed=1, faults=FaultPlan(**CHAOS)),
                            steps, C, seed=0)
    poison = nan_storm(steps, C, rate=0.02, seed=7)
    lost = sum(s.num_lost for s in scheds)
    check(lost > 0 and poison.any(), f"fault (a): {lost} lost commits, "
          f"{int(poison.sum())} poisons")

    def build(mode, dev, hooks=()):
        quad = Quadratic.make(rng.PRNGKey(0), d=4, m=1.0, L=3.0, device=dev)
        sampler = samplers.sgld(mode, lambda p, b, q=quad: q.grad(p, b), gamma=0.01,
                                sigma=0.5, tau=tau, fused=True)
        engine = ClusterEngine(sampler, num_chains=C, chunk_size=10, health_check=True,
                               hooks=list(hooks))
        return engine, engine.init(torch.zeros(4, device=dev), rng.PRNGKey(42))

    out, launches, card_runs = {}, dict.fromkeys(kernels, 0), {}
    for mode in ("inconsistent", "consistent"):
        runs = {}
        for dev in ("cpu", "cuda"):
            seen = []
            engine, state = build(mode, dev, [lambda n, st, aux: seen.append(st.health.copy())])
            r0 = _registry_value("chains.respawned")
            _reset(kernels)
            state, _ = engine.run(state, steps=steps, schedule=scheds, poison=poison)
            got = _counts(kernels)
            runs[dev] = (state, seen, _registry_value("chains.respawned") - r0)
            if dev == "cuda":
                want = dict.fromkeys(kernels, 0)
                want["langevin_update"] = steps
                if mode == "inconsistent":
                    want["wicon_read"] = steps
                check(got == want, f"fault (a) {mode}: launches {got}, want {want}")
                launches = {k: launches[k] + got[k] for k in kernels}
                card_runs[mode] = state
        (a, sa, ra), (b, sb, rb) = runs["cpu"], runs["cuda"]
        pa, pb = a.params.numpy(), b.params.cpu().numpy()
        err = float(np.abs(pa - pb).max())
        check(np.isfinite(pb).all() and np.allclose(pb, pa, rtol=PAPER_RTOL, atol=PAPER_ATOL),
              f"fault (a) {mode}: card and CPU differ by {err}")
        check(all(np.array_equal(x, y) for x, y in zip(sa, sb)) and len(sa) == len(sb),
              f"fault (a) {mode}: health masks differ: {sa} vs {sb}")
        check(ra == rb and ra > 0, f"fault (a) {mode}: respawns {ra} (CPU) vs {rb} (card)")
        check(a.key == b.key and torch.equal(a.inner[0].head, b.inner[0].head),
              f"fault (a) {mode}: keys or ring heads differ")
        quarantined = [int((~h).sum()) for h in sb]
        out[mode] = {"max_abs_err": err, "respawned": rb, "quarantined_by_chunk": quarantined}
        log(f"fault (a) {mode}: {C} chains x {steps} commits, {lost} lost, "
            f"{int(poison.sum())} poisoned; card == CPU within {err:.3g}; quarantined a "
            f"chunk {quarantined}, {int(rb)} respawned on both")
    # interrupt at commit 20, resume to 40: bitwise the uninterrupted card run
    full = card_runs["inconsistent"]
    with _ckpt_dir() as tmp:
        ck = str(Path(tmp) / "run.npz")
        engine, state = build("inconsistent", "cuda")
        engine.run(state, steps=20, schedule=scheds, poison=poison[:20], checkpoint_path=ck)
        engine, state = build("inconsistent", "cuda")
        res, _ = engine.resume(ck, state, steps=steps, schedule=scheds, poison=poison)
    same = (torch.equal(res.params, full.params) and res.key == full.key
            and np.array_equal(res.health, full.health) and res.step == full.step
            and torch.equal(res.inner[0].history, full.inner[0].history)
            and torch.equal(res.inner[0].head, full.inner[0].head))
    check(same, "fault (a): the resumed run is not bitwise the uninterrupted one")
    log("fault (a): interrupted at commit 20 and resumed: bitwise the uninterrupted run")
    out["launches"] = launches
    return out


def cluster_fault_path(torch, np, kernels, base: dict) -> dict:
    """(b) Phase 8c's cell (4 chains of qwen3-4b's widths at CLUSTER_LAYERS
    layers, fused W-Icon, tau 2, 3 commits in one chunk, the same start,
    schedules and batches) under health_check, with chain 1's last commit
    lost and chain 2 poisoned at the second commit: the lost commit leaves
    chain 1's parameters and ring head bitwise; chain 2 is quarantined,
    restored to its pre-commit iterate, and respawned from chain 0 at the
    boundary; chains 0 and 3 are bitwise phase 8c's (``base``).  Then the
    bank is saved (``save_ensemble``), the engine freed, and
    ``DecodeEngine.from_checkpoint`` greedy-decodes 8 tokens for 2
    prompts, as ``DecodeEngine.from_cluster`` did on the bank in memory."""
    from repro_torch import samplers
    from repro_torch.cluster import ClusterEngine, DecodeEngine, ensemble_async
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core import WorkerModel
    from repro_torch.core.delay import heads
    from repro_torch.data import make_batch
    from repro_torch.kernels import rng
    from repro_torch.models.transformer import Model, init_params
    from repro_torch.train.loop import make_grad_fn
    from repro_torch.utils import tree_leaves

    C, steps, tau, LOST, POISONED = 4, 3, 2, 1, 2
    cfg = replace(get_arch("qwen3-4b"), num_layers=CLUSTER_LAYERS)
    shape = ShapeConfig("cluster", seq_len=128, global_batch=8, kind="train")
    model = Model(cfg, device="cuda")
    sampler = samplers.sgld("inconsistent", make_grad_fn(model), gamma=1e-3,
                            sigma=1e-5, tau=tau, has_aux=True, fused=True)
    seen = []
    engine = ClusterEngine(sampler, num_chains=C, chunk_size=steps, collect_aux=True,
                           health_check=True,
                           batch_fn=lambda gen: make_batch(cfg, shape, gen, "train"),
                           hooks=[lambda n, st, aux: seen.append(st.health.copy())])
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda", num_chains=1)
    state = engine.init(params, rng.PRNGKey(0))
    del params
    schedules = ensemble_async(WorkerModel(num_workers=8), steps, C, seed=0)
    alive = np.ones(steps, bool)
    alive[steps - 1] = False
    schedules[LOST] = replace(schedules[LOST], alive=alive)
    poison = np.zeros((steps, C), bool)
    poison[1, POISONED] = True
    checks = []
    advance = engine._advance

    def spy(carry, batches, ex):
        k = len(checks)
        watch = LOST if k == steps - 1 else POISONED if k == 1 else None
        if watch is None:
            checks.append(True)
            return advance(carry, batches, ex)
        before = [t[watch].clone() for t in tree_leaves(carry.params)]
        head = heads(carry.inner[0])[watch]
        carry, aux = advance(carry, batches, ex)
        ok = (all(torch.equal(a, t[watch]) for a, t in zip(before, tree_leaves(carry.params)))
              and heads(carry.inner[0])[watch] == head)
        if watch == POISONED:
            ok = ok and not carry.health[POISONED]
        checks.append(ok)
        del before
        return carry, aux

    engine._advance = spy
    counts0 = {k: _registry_value(k) for k in ("chains.quarantined", "chains.respawned",
                                              "faults.injected")}
    _reset(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, aux = engine.run(state, steps=steps, schedule=schedules, key=0, poison=poison)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = _counts(kernels)
    leaves = tree_leaves(state.params)
    deltas = {k: _registry_value(k) - v for k, v in counts0.items()}
    check(checks == [True, True, True],
          f"fault (b): commit checks {checks} (commit 2: chain {POISONED} poisoned, "
          f"quarantined and restored; commit 3: chain {LOST}'s lost commit a no-op)")
    check(len(seen) == 1 and seen[0].tolist() == [True, True, False, True]
          and state.health.all(),
          f"fault (b): health at the boundary {seen}, after it {state.health}")
    check(deltas == {"chains.quarantined": 1.0, "chains.respawned": 1.0,
                     "faults.injected": 2.0}, f"fault (b): counters {deltas}")
    check(all(torch.equal(t[POISONED], t[0]) for t in leaves)
          and heads(state.inner[0])[POISONED] == heads(state.inner[0])[0],
          "fault (b): the respawned chain is not its donor's clone")
    for c, want in base["final"].items():
        check(all(torch.equal(t[c].cpu(), w) for t, w in zip(leaves, want)),
              f"fault (b): chain {c} is not bitwise phase 8c's")
    want = dict.fromkeys(kernels, 0)
    want.update(langevin_update=len(leaves) * steps, wicon_read=len(leaves) * steps)
    check(got == want, f"fault (b): launches {got}, want {want}")
    losses = aux["loss"]
    check(losses.shape == (steps, C) and np.isfinite(losses).all(),
          f"fault (b): losses {losses}")
    ms = wall * 1e3 / steps
    log(f"fault (b): {C} x {cfg.name} at {cfg.num_layers} layers, health_check: chain "
        f"{POISONED} poisoned at commit 2, quarantined, restored and respawned from chain 0; "
        f"chain {LOST}'s lost commit left it bitwise; chains {sorted(base['final'])} == "
        f"phase 8c bitwise; {ms:.2f} ms a commit (8c without health_check: "
        f"{base['ms_per_commit']:.2f}); launches {got}")

    prompts = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    eng = DecodeEngine.from_cluster(state, cfg, max_seq=64, device="cuda")
    check(eng.num_chains == C, f"fault (b): from_cluster serves {eng.num_chains} chains")
    tokens = eng.generate(prompts, 8).tokens
    with _ckpt_dir() as tmp:
        path = Path(tmp) / "bank.npz"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.save_ensemble(state, str(path))
        write_s = time.perf_counter() - t0
        gb = path.stat().st_size / 1e9
        del eng, state, leaves, engine, spy, advance, aux
        gc.collect()
        torch.cuda.empty_cache()
        like = init_params(cfg, device="meta", num_chains=1)
        t0 = time.perf_counter()
        eng = DecodeEngine.from_checkpoint(str(path), like, cfg, max_seq=64, device="cuda")
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
    again = eng.generate(prompts, 8).tokens
    check(eng.num_chains == C and np.array_equal(tokens, again),
          f"fault (b): from_checkpoint tokens {again.tolist()}, from_cluster "
          f"{tokens.tolist()}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    log(f"fault (b): save_ensemble {gb:.2f} GB in {write_s:.1f} s, from_checkpoint in "
        f"{read_s:.1f} s; 8 greedy tokens x 2 prompts equal from the file and from memory "
        f"({tokens.tolist()})")
    return {"launches": got, "ms_per_commit": ms, "ms_per_commit_8c": base["ms_per_commit"],
            "bank_gb": gb, "write_s": write_s, "read_s": read_s, "tokens": tokens.tolist()}


def run_checkpoint_path(torch, np, kernels) -> dict:
    """(c) A run checkpoint at full width, cut to 2 chains of qwen3-4b's
    widths at 1 layer, fused W-Icon, tau 1, health_check, one commit a
    chunk: the run's checkpoint after commit 1 restores into a fresh carry
    bitwise (every tensor, key, head and the health mask), and resuming it
    for one chunk is bitwise the uninterrupted 2-commit run.  Files go to a
    temporary directory, deleted after use."""
    from repro_torch import samplers
    from repro_torch.cluster import ClusterEngine, WorkerSchedule
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.data import make_batch
    from repro_torch.kernels import rng
    from repro_torch.models.transformer import Model, init_params
    from repro_torch.checkpoint import leaf_paths
    from repro_torch.train.loop import make_grad_fn
    from repro_torch.utils import tree_leaves

    C, tau, steps = 2, 1, 2
    cfg = replace(get_arch("qwen3-4b"), num_layers=1)
    shape = ShapeConfig("ckpt", seq_len=128, global_batch=8, kind="train")
    sampler = samplers.sgld("inconsistent", make_grad_fn(Model(cfg, device="cuda")),
                            gamma=1e-3, sigma=1e-5, tau=tau, has_aux=True, fused=True)
    engine = ClusterEngine(sampler, num_chains=C, chunk_size=1, health_check=True,
                           batch_fn=lambda gen: make_batch(cfg, shape, gen, "train"))
    schedule = WorkerSchedule.from_delays(np.array([0, 1]))

    def start():
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(1),
                             device="cuda", num_chains=1)
        return engine.init(params, rng.PRNGKey(1))

    def host(carry):
        return ([t.cpu() for t in tree_leaves(carry.params)],
                [t.cpu() for _, t in leaf_paths(carry.inner)],
                carry.key, carry.step, carry.health.copy())

    def same(a, b):
        return (all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
                and all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
                and a[2:4] == b[2:4] and np.array_equal(a[4], b[4]))

    _reset(kernels)
    full, _ = engine.run(start(), steps=steps, schedule=schedule, key=5)
    launches = _counts(kernels)
    want_full = host(full)
    del full
    gc.collect()
    torch.cuda.empty_cache()
    with _ckpt_dir() as tmp:
        ck = str(Path(tmp) / "run.npz")
        t0 = time.perf_counter()
        part, _ = engine.run(start(), steps=1, schedule=schedule, key=5, checkpoint_path=ck)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        gb = Path(ck).stat().st_size / 1e9
        want_part = host(part)
        del part
        gc.collect()
        torch.cuda.empty_cache()
        fresh = start()
        t0 = time.perf_counter()
        carry, done, _ = engine._load_run_checkpoint(ck, fresh)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        check(done == 1 and same(host(carry), want_part),
              "run checkpoint: the restored carry is not bitwise the saved one")
        del carry, fresh
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out, _ = engine.resume(ck, start(), steps=steps, schedule=schedule, key=5)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
    check(same(host(out), want_full),
          "run checkpoint: the resumed chunk is not bitwise the uninterrupted run")
    del out
    gc.collect()
    torch.cuda.empty_cache()
    log(f"fault (c): run checkpoint of {C} x {cfg.name} at 1 layer, tau {tau}: {gb:.2f} GB, "
        f"the 1-commit run with its write {run_s:.1f} s, read into a fresh carry "
        f"{read_s:.1f} s (bitwise), resume of one chunk {resume_s:.1f} s (bitwise the "
        f"uninterrupted run)")
    return {"launches": launches, "run_gb": gb, "run_with_write_s": run_s,
            "read_s": read_s, "resume_s": resume_s}


# ---------------------------------------------------------------------------
# phase 10: the main path, part 7 — the model zoo
# ---------------------------------------------------------------------------
def _free(torch) -> None:
    gc.collect()
    torch.cuda.empty_cache()


def _rel(a, b):
    """Relative L2 error of a against b over the last axis."""
    return (a - b).norm(dim=-1) / b.norm(dim=-1)


@contextlib.contextmanager
def _keep_every_pair(moe, cfg):
    """An MoE capacity that keeps every (token, expert) pair (factor E / k:
    capacity = tokens).  Phase 10a holds decode steps (2 tokens, capacity
    4: nothing drops) against one prefill of the whole stream, whose
    capacity at the reference's factor 1.25 drops pairs the steps keep;
    the drops themselves run in 10b and 10c."""
    prev = moe.CAPACITY_FACTOR
    if cfg.num_experts:
        moe.CAPACITY_FACTOR = cfg.num_experts / cfg.experts_per_token
    try:
        yield
    finally:
        moe.CAPACITY_FACTOR = prev


@contextlib.contextmanager
def _routing(moe, record=None, replay=None):
    """Expert choices in and out of ``moe.route``: ``record`` (a list) gets
    each call's ``(C, T, k)`` experts; ``replay`` (an iterator) gives each
    call's experts in place of the router's, weighted by the router's own
    probabilities there, renormalised.  Top-k routing is discontinuous: in
    bf16, the rounding differences between a decode step and a prefill flip
    experts whose probabilities nearly tie, and a flipped expert moves the
    logits as far as a wrong token would (phi3.5-moe at 16 layers: 1.28
    relative L2).  So phase 10a compares the paths under the decode's
    routing."""
    route = moe.route

    def wrapped(params, xt, cfg):
        probs, vals, idx = route(params, xt, cfg)
        if replay is not None:
            idx = next(replay)
            vals = probs.gather(-1, idx)
            vals = vals / vals.sum(dim=-1, keepdim=True)
        if record is not None:
            record.append(idx)
        return probs, vals, idx

    moe.route = wrapped
    try:
        yield
    finally:
        moe.route = route


@contextlib.contextmanager
def _plain_decode(ops):
    """The kernels' plain versions in ``kernels.ops`` on the card's tensors
    too (a comparison, so no launch is counted)."""
    route = ops._route
    ops._route = lambda t, kernel, plain: plain
    try:
        yield
    finally:
        ops._route = route


@contextlib.contextmanager
def _hold_decode(torch, ops, ds, ref, record: dict):
    """Every ring-kernel call through ``kernels.ops`` in the block held
    against the plain step on the same inputs: the plain step on copies of
    the caches, then the kernel on the caches themselves (its launch
    counted, as on the main path); the outputs within ``decode_limit``, the
    caches equal.  ``record`` gets the calls, their shapes ``(rows, smax)``,
    the largest |err| and the largest |err| over its limit (at most 0 to
    pass), and whether every cache was equal; read on the host at the end."""
    route = ops._route
    over = torch.full((), -math.inf, device="cuda")
    err = torch.zeros((), device="cuda")
    same = torch.ones((), dtype=torch.bool, device="cuda")
    shapes = set()

    def held(q, k_new, v_new, kc, vc, valid, slot):
        nonlocal over, err, same
        want, wk, wv = ref.decode_step_ref(q, k_new, v_new, kc.clone(), vc.clone(),
                                           valid, slot)
        o, kc, vc = ds.decode_step(q, k_new, v_new, kc, vc, valid, slot)
        d = (o.float() - want.float()).abs()
        limit = decode_limit(torch, str(q.dtype).replace("torch.", ""), want)
        over = torch.maximum(over, (d - limit).amax())
        err = torch.maximum(err, d.amax())
        same = same & (kc == wk).all() & (vc == wv).all()
        shapes.add((q.shape[0], kc.shape[1]))
        record["calls"] = record.get("calls", 0) + 1
        return o, kc, vc

    ops._route = lambda t, kernel, plain: (held if kernel is ds.decode_step
                                           else route(t, kernel, plain))
    try:
        yield
    finally:
        ops._route = route
        record.update(shapes=sorted(shapes), max_abs_err=err.item(),
                      over_limit=over.item(), caches_equal=bool(same))


def held_replay(torch, ds, model, params, stream, num_chains: int, what: str) -> dict:
    """The replay of ``stream`` through ``serve_step`` again, every ring-kernel
    call held against the plain step (``_hold_decode``): the kernel at the
    shapes, masks and caches the main path gives it.  A comparison: its
    launches are not the main path's."""
    from repro_torch.kernels import ops, ref

    B, T = stream.shape
    rec = {}
    with torch.no_grad(), _hold_decode(torch, ops, ds, ref, rec):
        cache = model.init_cache(B, T, num_chains=num_chains)
        for t in range(T):
            model.serve_step(params, cache, stream[:, t:t + 1], t)
        del cache
    want = model.cfg.num_layers * T
    check(rec.get("calls") == want, f"{what}: {rec.get('calls')} held ring-kernel calls, "
          f"want {want}")
    check(rec["over_limit"] <= 0, f"{what}: the ring kernel is {rec['over_limit']:.3g} past "
          f"the plain step's limit (max |err| {rec['max_abs_err']:.3g})")
    check(rec["caches_equal"], f"{what}: the ring kernel's caches differ from the plain step's")
    log(f"{what}: {rec['calls']} ring-kernel calls at (rows, slots) {rec['shapes']} held "
        f"against the plain step: max |err| {rec['max_abs_err']:.3g}, caches equal")
    return rec


def zoo_config(torch, np, ds, arch: str, device="cuda") -> dict:
    """(10a) One config at its published widths, a one-chain bank at
    ``ZOO_DEPTH`` layers (bf16, drawn on the card): ``Model.prefill`` of 2
    prompts x 64 tokens (after the frontend configs' stub positions), the
    prefill's K/V copied into an ``init_cache`` ring, then 8 greedy tokens
    through ``serve_step`` (the ring kernel once a layer a step).  Gate:
    each step's logits against one ``Model.forward`` of the same stream
    (``attention_any``, no kernel) at the same position, relative L2 error
    at most ``ZOO_REL_TOL`` (0.1), while the prefill's neighbouring
    position must be at least ``ZOO_SHIFT_MIN`` (0.5) away.  Why 0.1 for
    bf16: a bf16 rounding is up to 2^-9 relative, and the two paths round
    at different places (cuBLAS picks other kernels for 2 rows than for
    144, the decode kernel sums p . V in another order); the differences
    compound over the layers of random weights: 0.021-0.049 over 24-48
    layers in this script's first run on the card, which the bound clears
    twice over.  A kernel that dropped or misplaced positions moves the
    logits by a large part of their norm, as a one-position shift does
    (0.97-1.40 in that run).  The same steps through the plain decode
    step on the card give the kernel's share of the error (reported).
    MoE configs keep every pair (``_keep_every_pair``) and the forward and
    the plain steps take the kernel decode's expert choices
    (``_routing``).  stablelm-12b and kimi-k2 also serve one
    ``PagedDecodeEngine`` request (the paged kernel at head_dim 160 and
    112)."""
    from repro_torch.cluster import PagedDecodeEngine, Request
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.models.transformer import FRONTEND_DIM, Model, init_params
    from repro_torch.obs.metrics import registry
    from repro_torch.utils import tree_leaves, tree_map

    full = get_arch(arch)
    L = ZOO_DEPTH[arch]
    cfg = replace(full, num_layers=L)
    cut = None if L == full.num_layers else f"depth {full.num_layers} -> {L}"
    B, T, n_new, V = 2, 64, 8, cfg.vocab_size
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device=device, num_chains=1)
    torch.cuda.synchronize()
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    gb = sum(t.numel() * t.element_size() for t in leaves) / 1e9
    draw_s = time.perf_counter() - t0
    rng = np.random.default_rng(10)
    prompts = rng.integers(0, V, (B, T)).astype(np.int32)
    batch = {"tokens": prompts}
    N = cfg.num_frontend_tokens if cfg.frontend else 0
    if cfg.frontend:
        batch["frontend"] = torch.randn(B, N, FRONTEND_DIM,
                                        generator=torch.Generator().manual_seed(11))
    P = N + T
    model = Model(cfg, device=device)
    out = {"arch": arch, "reduced": cut, "layers": L, "params_b": n_params / 1e9,
           "bank_gb": gb, "head_dim": cfg.head_dim,
           "group": cfg.num_heads // cfg.num_kv_heads}
    seen_pre, seen_dec = [], []
    with torch.no_grad(), _keep_every_pair(moe, cfg):
        moe.reset_dropped()
        t0 = time.perf_counter()
        with _routing(moe, record=seen_pre):
            last, pre = model.prefill(params, batch)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        cache = model.init_cache(B, P + n_new, prefill_len=P)
        for name in ("k", "v"):
            cache["attn"][name][:, :, :, :P] = pre["attn"][name]
        del pre
        start = tree_map(torch.clone, cache)
        tok = last[0, :, 0].argmax(-1)
        fed, dec = [], []
        ds.decode_step.launches = ds.paged_decode_step.launches = 0
        t0 = time.perf_counter()
        with _routing(moe, record=seen_dec):
            for i in range(n_new):
                fed.append(tok)
                step, cache = model.serve_step(params, cache, tok[:, None], P + i)
                dec.append(step[0, :, 0].float())
                tok = dec[-1].argmax(-1)
            torch.cuda.synchronize()
        ms_tok = (time.perf_counter() - t0) * 1e3 / n_new
        launches = ds.decode_step.launches
        check(ds.paged_decode_step.launches == 0, f"{arch}: paged kernel in serve_step")
        del cache
        # the same steps through the plain decode step, the kernel decode's
        # expert choices
        plain, cache = [], start
        with _plain_decode(ops), _routing(moe, replay=iter(seen_dec)):
            for i in range(n_new):
                step, cache = model.serve_step(params, cache, fed[i][:, None], P + i)
                plain.append(step[0, :, 0].float())
        del cache, start
        stream = np.concatenate([prompts, torch.stack(fed, 1).cpu().numpy().astype(np.int32)],
                                axis=1)
        k = cfg.experts_per_token
        choices = [torch.cat([seen_pre[l].reshape(1, B, P, k),
                              torch.stack([seen_dec[i * L + l].reshape(1, B, k)
                                           for i in range(n_new)], dim=2)],
                             dim=2).reshape(1, B * (P + n_new), k)
                   for l in range(L)] if cfg.num_experts else []
        with _routing(moe, replay=iter(choices)):
            logits, _, _ = model.forward(params, {**batch, "tokens": stream})
        ref = logits[0, :, P:P + n_new].float()  # (B, n_new, V)
        del logits
        dropped = moe.dropped_pairs()
    dec, plain = torch.stack(dec, 1), torch.stack(plain, 1)
    check(bool(torch.isfinite(dec).all()), f"{arch}: non-finite decode logits")
    check(launches == L * n_new,
          f"{arch}: decode kernel launched {launches} times for {n_new} steps x {L} layers")

    err = _rel(dec, ref).max().item()
    shifted = _rel(dec[:, 1:], ref[:, :-1]).min().item()
    check(err <= ZOO_REL_TOL,
          f"{arch}: decode logits {err:.4g} from the prefill's (relative L2), "
          f"limit {ZOO_REL_TOL}")
    check(shifted >= ZOO_SHIFT_MIN, f"{arch}: the prefill's neighbouring position is "
          f"only {shifted:.4g} from the decode logits")
    check(dropped == 0, f"{arch}: {dropped} pairs dropped with every pair kept")
    agree = float((dec.argmax(-1) == ref.argmax(-1)).float().mean())
    out.update(prefill_ms=prefill_ms, ms_per_token=ms_tok, launches=launches,
               launches_per_step=launches // n_new, decode_vs_prefill_rel_l2=err,
               plain_vs_prefill_rel_l2=_rel(plain, ref).max().item(),
               decode_vs_plain_rel_l2=_rel(dec, plain).max().item(),
               shifted_rel_l2_min=shifted, argmax_agreement=agree,
               decode_vs_prefill_max_abs=(dec - ref).abs().max().item())
    if arch in ("stablelm-12b", "kimi-k2-1t-a32b"):
        reg = registry()
        with torch.no_grad(), _keep_every_pair(moe, cfg):
            peng = PagedDecodeEngine(cfg, params, num_slots=2, page_size=16,
                                     max_seq=128, device=device)
            micro0 = reg.counter("paged.micro_steps").value
            ds.decode_step.launches = ds.paged_decode_step.launches = 0
            t0 = time.perf_counter()
            rid = peng.submit(Request(tokens=prompts[0], max_new_tokens=n_new))
            done = {c.request_id: c for c in peng.drain()}[rid]
            paged_s = time.perf_counter() - t0
            micro = int(reg.counter("paged.micro_steps").value - micro0)
            paged = ds.paged_decode_step.launches
        check(done.status == "ok" and len(done.tokens) == n_new,
              f"{arch}: paged request {done.status}, {len(done.tokens)} tokens")
        check(paged == L * micro and ds.decode_step.launches == 0,
              f"{arch}: paged kernel launched {paged} times for {micro} micro-steps x {L}")
        out["paged"] = {"launches": paged, "micro_steps": micro,
                        "tokens_per_s": n_new / paged_s,
                        "tokens_equal_ring": done.tokens.tolist() == [int(t[0]) for t in fed]}
        del peng
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, model, dec, plain, ref, seen_pre, seen_dec, choices
    _free(torch)
    log(f"zoo (a): {arch}{f' ({cut})' if cut else ''}, {n_params / 1e9:.3f} B parameters, "
        f"{gb:.2f} GB (drawn in {draw_s:.1f} s), hd {cfg.head_dim}, group {out['group']}: "
        f"prefill 2 x {P} in {prefill_ms:.1f} ms; {ms_tok:.2f} ms/token, "
        f"{launches // n_new} kernel launches a step; decode vs prefill relative L2 "
        f"{err:.3g} (plain step {out['plain_vs_prefill_rel_l2']:.3g}, kernel vs plain "
        f"{out['decode_vs_plain_rel_l2']:.3g}, a shifted position {shifted:.3g}), argmax "
        f"agreement {agree:.3f}; peak {out['peak_gb']:.2f} GB"
        + (f"; paged request {out['paged']['tokens_per_s']:.1f} tokens/s, "
           f"{out['paged']['launches']} launches" if "paged" in out else ""))
    return out


def moe_serve_path(torch, np, ds, device="cuda") -> dict:
    """(10b) MoE serving: a 2-chain phi3.5-moe bank at its published widths,
    depth cut 32 -> ``MOE_SERVE_LAYERS``, at the reference's capacity
    factor: ``DecodeEngine`` (4 prompts x 32 + 16 new tokens),
    ``PagedDecodeEngine`` (the same 4 requests on 8 slots, page size 16),
    then one ``ServeEngine`` request of 8 x 128 tokens; the dropped (token,
    expert) pairs of each part are counted."""
    from repro_torch.cluster import DecodeEngine, PagedDecodeEngine, Request, ServeEngine
    from repro_torch.configs import get_arch
    from repro_torch.models import moe, transformer_next_token_predict
    from repro_torch.models.transformer import Model, init_params
    from repro_torch.obs.metrics import registry
    from repro_torch.utils import tree_leaves

    full = get_arch("phi3.5-moe-42b-a6.6b")
    L, C = MOE_SERVE_LAYERS, 2
    cfg = replace(full, num_layers=L)
    V = cfg.vocab_size
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(3),
                         device=device, num_chains=C)
    gb = sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 1e9
    rng = np.random.default_rng(12)
    prompts = rng.integers(0, V, (4, 32)).astype(np.int32)
    out = {"arch": cfg.name, "reduced": f"depth {full.num_layers} -> {L}", "chains": C,
           "bank_gb": gb}

    eng = DecodeEngine(cfg, params, max_seq=256, device=device)
    eng.generate(prompts, 2)  # warm-up
    torch.cuda.synchronize()
    moe.reset_dropped()
    ds.decode_step.launches = ds.paged_decode_step.launches = 0
    t0 = time.perf_counter()
    res = eng.generate(prompts, 16)
    t_dec = time.perf_counter() - t0
    launches = ds.decode_step.launches
    check(res.tokens.shape == (4, 16) and ((res.tokens >= 0) & (res.tokens < V)).all(),
          f"moe serve: DecodeEngine tokens {res.tokens.shape}")
    check(launches == L * 15, f"moe serve: decode kernel launched {launches} times, "
          f"want {L} x 15")
    out["decode"] = {"launches": launches, "ms_per_token": t_dec * 1e3 / 16,
                     "tokens_per_s": 64 / t_dec, "dropped_pairs": moe.dropped_pairs()}
    del eng
    _free(torch)

    reg = registry()
    peng = PagedDecodeEngine(cfg, params, num_slots=8, page_size=16, max_seq=256,
                             device=device)
    moe.reset_dropped()
    ds.decode_step.launches = ds.paged_decode_step.launches = 0
    micro0 = reg.counter("paged.micro_steps").value
    t0 = time.perf_counter()
    ids = [peng.submit(Request(tokens=p, max_new_tokens=16)) for p in prompts]
    done = {c.request_id: c for c in peng.drain()}
    t_paged = time.perf_counter() - t0
    micro = int(reg.counter("paged.micro_steps").value - micro0)
    paged = ds.paged_decode_step.launches
    check(all(done[i].status == "ok" and len(done[i].tokens) == 16 for i in ids),
          "moe serve: a paged request failed")
    check(paged == L * micro and ds.decode_step.launches == 0,
          f"moe serve: paged kernel launched {paged} times for {micro} micro-steps x {L}")
    out["paged"] = {"launches": paged, "micro_steps": micro, "tokens_per_s": 64 / t_paged,
                    "dropped_pairs": moe.dropped_pairs()}
    del peng
    _free(torch)

    serve = ServeEngine(predict_fn=transformer_next_token_predict(Model(cfg, device=device)),
                        params=params, device=device)
    queries = rng.integers(0, V, (8, 128)).astype(np.int32)
    serve({"tokens": queries[:1]})  # warm-up
    torch.cuda.synchronize()
    moe.reset_dropped()
    t0 = time.perf_counter()
    r = serve({"tokens": queries})
    ms = (time.perf_counter() - t0) * 1e3
    check(r.mean.shape == (8, V) and all(np.isfinite(x).all() for x in r),
          "moe serve: ServeEngine statistics not finite or misshapen")
    out["serve"] = {"queries": 8, "tokens": 128, "ms_per_request": ms,
                    "queries_per_s": 8e3 / ms, "dropped_pairs": moe.dropped_pairs()}
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del serve, params
    _free(torch)
    log(f"moe serve: {C} x {cfg.name} ({out['reduced']}), {gb:.2f} GB: DecodeEngine "
        f"{out['decode']['ms_per_token']:.2f} ms/token ({out['decode']['tokens_per_s']:.1f} "
        f"tokens/s, {launches} launches), PagedDecodeEngine "
        f"{out['paged']['tokens_per_s']:.1f} tokens/s ({paged} launches), ServeEngine "
        f"8 x 128 in {ms:.1f} ms; dropped pairs {out['decode']['dropped_pairs']}, "
        f"{out['paged']['dropped_pairs']}, {out['serve']['dropped_pairs']}; peak "
        f"{out['peak_gb']:.2f} GB")
    return out


# ---------------------------------------------------------------------------
# phase 11: the main path, part 8 — the recurrent configs
# ---------------------------------------------------------------------------
def recurrent_serve(torch, np, ds, arch: str, gate="stream", device="cuda") -> dict:
    """(11a, 11c) One recurrent config at its published widths and depth, a
    bank of ``RECURRENT_CHAINS`` chains in bf16 drawn on the card, served by
    replay (its stack has no prefill-fillable cache, as in the reference):
    4 prompts x 32 tokens through ``serve_step`` from ``init_cache``, then
    16 greedy tokens from the bank's BMA law, each fed back.  hymba's ring
    kernel runs once a layer a step (G 5), and the stream is replayed once
    more with every kernel call held against the plain step
    (``held_replay``); xlstm has no attention, so no kernel.

    Gate ``"stream"`` (hymba): every step's logits (each chain, each row)
    against one ``Model.forward`` of the same 48-token stream at that
    position, relative L2 at most ``ZOO_REL_TOL``, and the forward's
    neighbouring position at least ``ZOO_SHIFT_MIN`` away, as in
    ``zoo_config``.  Gate ``"layers"`` (xlstm): a random-weight xLSTM
    stack amplifies any rounding difference layer after layer (its
    gradient at init reaches 3e4, ``xlstm_grad_scale``), so its replay and
    its forward part further with every layer, by as much as a shifted
    position at 48 bf16 layers; the JAX package's part as far as the
    port's at 8 and 16 layers (``scripts/torch_recurrent_witness.py`` on a
    CPU, which cannot hold the JAX package at 48).  The stream's error is
    reported, and the gate holds each layer instead: every layer's decode
    step, fed the forward's input to that layer at that position
    (teacher-forced) and its own recurrent state, against the forward's output of the layer there —
    the block's increment, relative L2 at most ``ZOO_REL_TOL`` at every
    position, while each layer's steps against the forward's a position
    late must be at least ``ZOO_SHIFT_MIN`` away over each row's stream
    (a slow sLSTM's neighbouring positions may lie closer one by one)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import bma_logits
    from repro_torch.models.transformer import Model, init_params
    from repro_torch.utils import tree_leaves

    cfg = get_arch(arch)
    C, B, P, n_new = RECURRENT_CHAINS, 4, 32, 16
    T, L, V = P + n_new, cfg.num_layers, cfg.vocab_size
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(20),
                         device=device, num_chains=C)
    gb = sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 1e9
    model = Model(cfg, device=device)
    stream = torch.zeros(B, T, dtype=torch.long, device=device)
    stream[:, :P] = torch.from_numpy(
        np.random.default_rng(21).integers(0, V, (B, P))).to(device)
    with torch.no_grad():
        cache = model.init_cache(B, T, num_chains=C)
        state_gb = sum(t.numel() * t.element_size() for t in tree_leaves(cache)) / 1e9
        steps = []
        ds.decode_step.launches = ds.paged_decode_step.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(T):
            logits, cache = model.serve_step(params, cache, stream[:, t:t + 1], t)
            steps.append(logits[:, :, 0].float())
            if P - 1 <= t < T - 1:
                stream[:, t + 1] = bma_logits(logits[:, :, 0]).argmax(-1)
            if t == P - 1:
                torch.cuda.synchronize()
                t_prompt = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ds.decode_step.launches
        del cache
        dec = torch.stack(steps, 2)  # (C, B, T, V)
        del steps
        t1 = time.perf_counter()
        ref, _, _ = model.forward(params, {"tokens": stream})
        torch.cuda.synchronize()
        forward_ms = (time.perf_counter() - t1) * 1e3
        ref = ref.float()
    check(bool(torch.isfinite(dec).all()), f"{arch}: non-finite replay logits")
    want = L * T if cfg.block_pattern[0] == "hymba_mlp" else 0
    check(launches == want and ds.paged_decode_step.launches == 0,
          f"{arch}: decode kernel launched {launches} times for {T} steps x {L} "
          f"layers, want {want}")
    held = held_replay(torch, ds, model, params, stream, C, arch) if want else None
    err = stream_err = _rel(dec, ref).max().item()
    shifted = stream_shifted = _rel(dec[:, :, 1:], ref[:, :, :-1]).min().item()
    agree = float((dec.argmax(-1) == ref.argmax(-1)).float().mean())
    del dec, ref
    if gate == "layers":
        with torch.no_grad():
            err, shifted = layer_replay(torch, model, params, stream)
        what = "a layer's decode step"
    else:
        what = "replay logits"
    check(err <= ZOO_REL_TOL, f"{arch}: {what} {err:.4g} from the forward's (relative "
          f"L2), limit {ZOO_REL_TOL}")
    check(shifted >= ZOO_SHIFT_MIN, f"{arch}: the forward's neighbouring position is "
          f"only {shifted:.4g} from {what}")
    out = {"arch": arch, "gate": gate, "chains": C, "rows": B, "prompt": P,
           "new_tokens": n_new,
           "layers": L, "bank_gb": gb, "state_gb": state_gb, "launches": launches,
           "ms_per_step": wall * 1e3 / T, "prompt_replay_ms": t_prompt * 1e3,
           "ms_per_token": (wall - t_prompt) * 1e3 / n_new,
           "tokens_per_s": B * n_new / (wall - t_prompt), "forward_ms": forward_ms,
           "replay_vs_forward_rel_l2": stream_err, "stream_shifted_rel_l2_min":
           stream_shifted, "argmax_agreement": agree, "gate_rel_l2": err,
           "gate_shifted_rel_l2_min": shifted, "held": held,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del params, model
    _free(torch)
    log(f"recurrent serve: {C} x {arch} ({L} layers), {gb:.2f} GB of weights, "
        f"{state_gb:.2f} GB of decode state; {B} x {P} prompt tokens replayed in "
        f"{t_prompt * 1e3:.1f} ms, then {out['ms_per_token']:.2f} ms/token "
        f"({out['tokens_per_s']:.1f} tokens/s); {launches} kernel launches; replay vs "
        f"forward relative L2 {stream_err:.3g} (a shifted position {stream_shifted:.3g}), "
        f"argmax agreement {agree:.3f}; gate ({gate}) {err:.3g}, shifted {shifted:.3g}; "
        f"peak {out['peak_gb']:.2f} GB")
    return out


def layer_replay(torch, model, params, stream):
    """Each layer's decode step against its forward, teacher-forced: the
    forward's input to layer l at position t, through ``serve_step``'s
    block with layer l's own recurrent state (carried from t - 1), against
    the forward's output of layer l at t (both read and fed through the
    ``tap`` of ``Model.hidden`` and ``Model.serve_step``).  Compares the
    block's increment (output minus input).  Returns (the largest relative
    L2 over layers, chains, rows and positions; the least over layers,
    chains and rows of the relative L2 of a row's steps against the
    forward's a position late, over its whole stream)."""
    L = model.cfg.num_layers
    xs = []  # the input to each layer, the last layer's output
    model.hidden(params, {"tokens": stream}, tap=lambda i, x: xs.append(x) or x)
    C, B, T = xs[0].shape[:3]
    inc = [(xs[i + 1] - xs[i]).float() for i in range(L)]
    cache = model.init_cache(B, T, num_chains=C)
    steps = [[] for _ in range(L)]
    for t in range(T):
        def force(i, x, t=t):
            if i:  # layer i - 1's step: its increment over the forward's input
                steps[i - 1].append((x - xs[i - 1][:, :, t:t + 1]).float()[:, :, 0])
            return xs[i][:, :, t:t + 1] if i < L else x
        model.serve_step(params, cache, stream[:, t:t + 1], t, tap=force)
    err, shifted = 0.0, math.inf
    for i, s in enumerate(steps):
        s = torch.stack(s, 2)  # (C, B, T, d)
        err = max(err, _rel(s, inc[i]).max().item())
        # a layer's steps a position late, over the whole stream of each row
        d = (s[:, :, 1:] - inc[i][:, :, :-1]).flatten(2).norm(dim=-1)
        shifted = min(shifted, (d / inc[i][:, :, :-1].flatten(2).norm(dim=-1)).min().item())
    return err, shifted


def hymba_window(torch, np, ds, device="cuda") -> dict:
    """(11b) hymba-1.5b's sliding window at its published widths, one chain,
    depth cut 32 -> ``WINDOW_LAYERS``: one stream of ``WINDOW_TOKENS``
    (17 x 64) replayed through ``serve_step``, so the ring of 1,024 slots
    wraps and the window drops positions; gate as ``recurrent_serve``'s
    over the last 64 positions, against ``Model.forward`` (SDPA under the
    window mask above 512 tokens, the SSD scan in chunks of 64); then the
    replay again with every kernel call held against the plain step
    (``held_replay``)."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import Model, init_params

    full = get_arch("hymba-1.5b")
    L, T = WINDOW_LAYERS, WINDOW_TOKENS
    cfg = replace(full, num_layers=L)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(22),
                         device=device, num_chains=1)
    model = Model(cfg, device=device)
    stream = torch.from_numpy(np.random.default_rng(23).integers(
        0, cfg.vocab_size, (1, T))).to(device)
    last = []
    with torch.no_grad():
        cache = model.init_cache(1, T)
        smax = cache["attn"]["k"].shape[3]
        ds.decode_step.launches = ds.paged_decode_step.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(T):
            logits, cache = model.serve_step(params, cache, stream[:, t:t + 1], t)
            if t >= T - 64:
                last.append(logits[0, 0, 0].float())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ds.decode_step.launches
        pos = cache["attn"]["pos"][0]
        held = (int(pos.min()), int(pos.max()))
        del cache
        ref, _, _ = model.forward(params, {"tokens": stream})
        ref = ref[0, 0, T - 64:].float()
    dec = torch.stack(last)
    check(smax == full.sliding_window, f"hymba window: a ring of {smax} slots")
    check(held == (T - smax, T - 1), f"hymba window: the ring holds positions {held}")
    check(launches == L * T, f"hymba window: decode kernel launched {launches} times, "
          f"want {L} x {T}")
    hold = held_replay(torch, ds, model, params, stream, 1, "hymba window")
    err = _rel(dec, ref).max().item()
    shifted = _rel(dec[1:], ref[:-1]).min().item()
    check(err <= ZOO_REL_TOL, f"hymba window: replay logits {err:.4g} from the "
          f"forward's (relative L2), limit {ZOO_REL_TOL}")
    check(shifted >= ZOO_SHIFT_MIN, f"hymba window: the forward's neighbouring position "
          f"is only {shifted:.4g} from the replay's")
    out = {"arch": "hymba-1.5b", "reduced": f"depth {full.num_layers} -> {L}",
           "tokens": T, "ring_slots": smax, "ring_positions": list(held),
           "launches": launches, "ms_per_step": wall * 1e3 / T,
           "replay_vs_forward_rel_l2": err, "shifted_rel_l2_min": shifted, "held": hold}
    del params, model, dec, ref
    _free(torch)
    log(f"hymba window: {L} layers, one {T}-token stream replayed at "
        f"{out['ms_per_step']:.2f} ms a step, the {smax}-slot ring holding positions "
        f"{held[0]}-{held[1]}; last 64 positions against the forward: relative L2 "
        f"{err:.3g} (a shifted position {shifted:.3g}); {launches} kernel launches")
    return out


def slstm_launches(torch, device="cuda") -> dict:
    """The sLSTM time loop's operations on the card at the training cell's
    shape (one chain, 8 x 128 tokens, xlstm-1.3b's widths): aten operations
    that are not views (each one kernel launch or none) in one layer's
    forward and backward, counted by a dispatch mode (no profiler)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.configs import get_arch
    from repro_torch.models.xlstm import apply_slstm, init_slstm

    views = {"view", "_unsafe_view", "t", "transpose", "expand", "slice", "select",
             "split", "unsqueeze", "squeeze", "permute", "detach", "alias",
             "split_with_sizes", "as_strided", "unbind", "_reshape_alias"}

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ not in views:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    cfg = get_arch("xlstm-1.3b")
    p = init_slstm(torch.Generator(device=device).manual_seed(24), cfg, torch.bfloat16,
                   (1,), device)
    for t in p.values():
        t.requires_grad_()
    x = torch.randn(1, 8, 128, cfg.d_model, device=device, dtype=torch.bfloat16,
                    generator=torch.Generator(device=device).manual_seed(25))
    with Count():
        y = apply_slstm(p, x, cfg)
    fwd = Count.n
    with Count():
        y.float().square().mean().backward()
    out = {"forward_ops": fwd, "backward_ops": Count.n - fwd, "positions": 128,
           "ops_per_position_forward": fwd / 128}
    log(f"sLSTM loop (one layer, 8 x 128 tokens): {fwd} operations forward, "
        f"{Count.n - fwd} backward ({fwd / 128:.1f} a position forward)")
    return out


def xlstm_grad_scale(torch, np, device="cuda") -> dict:
    """The size of xlstm-1.3b's gradient at its random init, the reason 11d
    trains it at ``RECURRENT_TRAIN_GAMMA``: one chain at its published
    widths and depth in bf16, one gradient of the training cell's batch (8 x
    129 tokens from a numpy seed): the largest |gradient| of each layer and
    of the embedding."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import Model, init_params
    from repro_torch.train.loop import make_grad_fn
    from repro_torch.utils import tree_leaves

    cfg = get_arch("xlstm-1.3b")
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device=device, num_chains=1)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (8, 129))
    grads, metrics = make_grad_fn(Model(cfg, device=device))(params, {"tokens": tokens})
    largest = lambda tree: max(float(t.float().abs().max()) for t in tree_leaves(tree))  # noqa: E731
    layers = [largest(g) for g in grads["layers"]]
    out = {"loss": float(metrics["loss"]), "embed_max_abs": largest(grads["embed"]),
           "layer_max_abs": layers, "largest_layer": max(range(len(layers)), key=layers.__getitem__)}
    check(all(map(math.isfinite, layers)), "xlstm: non-finite gradient at init")
    del params, grads
    _free(torch)
    log(f"xlstm-1.3b gradient at init (8 x 129 tokens, bf16): embedding {out['embed_max_abs']:.4g}, "
        f"largest layer {out['largest_layer']} {max(layers):.4g}, last layer {layers[-1]:.4g}")
    return out


def recurrent_reference_check(torch, np, lu, dg, ds) -> dict:
    """(11e) Reduced float32 hymba at 5 query heads over 1 KV head, d_model
    320 (the SSD head dim 2 * 320 / 5 an integer; the window 64), and the
    reduced xlstm: 80 tokens replayed on the card (the ring kernel at G 5)
    and on the CPU (plain), logits within 1e-4; then 4 fused W-Icon commits
    of each, card against CPU, as phase 3 (``training_reference_check``)."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.transformer import Model, init_params
    from repro_torch.utils import tree_map

    cfgs = [replace(get_reduced("hymba-1.5b"), num_heads=5, num_kv_heads=1,
                    d_model=320, dtype="float32"),
            replace(get_reduced("xlstm-1.3b"), dtype="float32")]
    out = {}
    for cfg in cfgs:
        cpu = init_params(cfg, torch.Generator().manual_seed(26), device="cpu",
                          num_chains=2)
        gpu = tree_map(lambda t: t.to("cuda"), cpu)
        stream = np.random.default_rng(27).integers(0, cfg.vocab_size, (2, 80))
        runs = {}
        ds.decode_step.launches = 0
        for dev, params in (("cpu", cpu), ("cuda", gpu)):
            model = Model(cfg, device=dev)
            with torch.no_grad():
                cache = model.init_cache(2, 80, num_chains=2)
                steps = []
                for t in range(80):
                    logits, cache = model.serve_step(params, cache, stream[:, t:t + 1], t)
                    steps.append(logits.cpu())
            runs[dev] = torch.cat(steps, 2)
        launches = ds.decode_step.launches
        want = cfg.num_layers * 80 if cfg.block_pattern[0] == "hymba_mlp" else 0
        check(launches == want, f"{cfg.name}: card replay launched the decode kernel "
              f"{launches} times, want {want}")
        err = float((runs["cpu"] - runs["cuda"]).abs().max())
        check(err <= 1e-4, f"{cfg.name}: card replay logits differ from the CPU's by {err}")
        train = training_reference_check(torch, np, lu, dg, cfg)
        out[cfg.name] = {"replay_max_abs_err": err, "replay_launches": launches, **train}
        log(f"reference replay {cfg.name}: 80 tokens x 2 chains, card == CPU within "
            f"{err:.3g}, {launches} kernel launches")
    return out


# ---------------------------------------------------------------------------
# phase 12: the tooling — instrumentation, timelines, the prefetcher, the
# roofline and the dry run
# ---------------------------------------------------------------------------
TOOLING_LAYERS = 4  # qwen3-4b's widths, depth cut as the cluster-full cell's
TOOLING_OUT = ROOT / "smoke_out" / "tooling"  # timelines and dry-run JSONs
PREFETCH_STEPS, PREFETCH_CHUNK = 6, 3


def _timeline(name: str, trace: dict) -> dict:
    """Write a timeline under TOOLING_OUT, validate it, log its summary."""
    from repro_torch.obs.timeline import summarize, validate_chrome_trace, write_chrome_trace

    TOOLING_OUT.mkdir(parents=True, exist_ok=True)
    write_chrome_trace(TOOLING_OUT / f"{name}.timeline.json", trace)
    problems = validate_chrome_trace(trace)
    check(problems == [], f"tooling: the {name} timeline is invalid: {problems[:3]}")
    s = summarize(trace)
    n_events = sum(ev.get("ph") == "X" for ev in trace["traceEvents"])
    check(n_events > 0, f"tooling: the {name} timeline is empty")
    crit = s["critical"]
    log(f"tooling: {name} timeline: {n_events} spans, makespan {s['makespan_s']:.3f} s, "
        f"critical row {crit['label']} busy {crit['busy_s']:.3f} s; "
        f"tokens by rung {s['tokens_by_rung']}; staleness {s['staleness_hist']}")
    return {"spans": n_events, "makespan_s": s["makespan_s"], "critical": crit["label"]}


def tooling_streams(torch, np, ds, cfg) -> dict:
    """(1) The decode and paged cells' traffic on a 4-chain bank at
    TOOLING_LAYERS layers, warmed up, then replayed under ``instrument()``
    with the tracer on: no new rung, no pad scratch, both timelines valid."""
    from repro_torch.analysis import instrument
    from repro_torch.cluster import DecodeEngine, PagedDecodeEngine, Request
    from repro_torch.models.transformer import init_params
    from repro_torch.obs.timeline import decode_timeline, paged_timeline
    from repro_torch.obs.trace import tracer

    C, L, V = 4, cfg.num_layers, cfg.vocab_size
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda", num_chains=C)
    r = np.random.default_rng(0)
    prompts = r.integers(0, V, (4, 32)).astype(np.int32)
    lens = [8, 96, 17, 64, 33, 8, 80, 45, 12, 96, 24, 50]
    budgets = [32, 4, 16, 24, 8, 32, 12, 4, 20, 16, 28, 6]
    reqs = [r.integers(0, V, (t,)).astype(np.int32) for t in lens]
    dec = DecodeEngine(cfg, params, max_seq=256, device="cuda")
    pag = PagedDecodeEngine(cfg, params, num_slots=8, page_size=16, max_seq=256,
                            decode_chunk=8, device="cuda")

    def decode_stream():
        dec.generate(prompts, 16)
        dec.generate(prompts[:1], 16, key=1234)

    def paged_stream():
        early = []
        for i, (p, n) in enumerate(zip(reqs, budgets)):
            if i == 10:
                early = pag.step()  # slots full: the priority requests preempt
            pag.submit(Request(tokens=p, max_new_tokens=n, priority=int(i >= 10),
                               key=None if i % 3 else 77 + i))
        return early + pag.drain()

    out = {}
    tr = tracer()
    for name, stream, timeline in (("decode", decode_stream, decode_timeline),
                                   ("paged", paged_stream, paged_timeline)):
        stream()  # warm-up: every rung met, every scratch made
        torch.cuda.synchronize()
        ds.decode_step.launches = ds.paged_decode_step.launches = 0
        tr.clear()
        tr.enable()
        try:
            with instrument() as rep:
                stream()
        finally:
            tr.disable()
        flags = rep.stream_flags()
        check(flags == {"retraced_in_stream": False, "pad_allocs_in_stream": 0},
              f"tooling: the warm {name} stream met new rungs: {rep.to_dict()}")
        launches = {"decode_step": ds.decode_step.launches,
                    "paged_decode_step": ds.paged_decode_step.launches}
        kernel = "decode_step" if name == "decode" else "paged_decode_step"
        check(launches[kernel] > 0 and launches[kernel] % L == 0
              and sum(launches.values()) == launches[kernel],
              f"tooling: {name} stream launches {launches}")
        out[name] = {"stream_flags": flags, "report": rep.to_dict(), "launches": launches,
                     "timeline": _timeline(name, timeline(tr.drain()))}
        log(f"tooling: warm {name} stream under instrument(): {flags}; launches {launches}")
    del dec, pag, params
    return out


def tooling_cluster(torch, np, kernels, cfg) -> dict:
    """(2) Three fused W-Icon ClusterEngine commits (C 4, tau 2) under
    ``instrument(transfer_guard="error")``: the fault-free path reads
    nothing back, so the region passes; the same commits under
    ``health_check`` (one (C,) flag read a commit) must raise; the run's
    cluster timeline is valid."""
    from repro_torch import samplers
    from repro_torch.analysis import instrument
    from repro_torch.cluster import ClusterEngine, ensemble_async
    from repro_torch.configs import ShapeConfig
    from repro_torch.core import WorkerModel
    from repro_torch.data import make_batch
    from repro_torch.kernels import rng
    from repro_torch.models.transformer import Model, init_params
    from repro_torch.obs.timeline import cluster_timeline
    from repro_torch.train.loop import make_grad_fn
    from repro_torch.utils import tree_leaves

    C, steps, tau = 4, 3, 2
    shape = ShapeConfig("cluster", seq_len=128, global_batch=8, kind="train")
    model = Model(cfg, device="cuda")
    sampler = samplers.sgld("inconsistent", make_grad_fn(model), gamma=1e-3,
                            sigma=1e-5, tau=tau, has_aux=True, fused=True)
    schedules = ensemble_async(WorkerModel(num_workers=8), steps, C, seed=0)

    def engine(health):
        return ClusterEngine(sampler, num_chains=C, chunk_size=steps, health_check=health,
                             batch_fn=lambda gen: make_batch(cfg, shape, gen, "train"))

    eng = engine(False)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda", num_chains=1)
    state = eng.init(params, rng.PRNGKey(0))
    del params
    state, _ = eng.run(state, steps=1, schedule=ensemble_async(
        WorkerModel(num_workers=8), 1, C, seed=1), key=1)  # warm-up
    torch.cuda.synchronize()
    _reset(kernels)
    t0 = time.perf_counter()
    with instrument(transfer_guard="error") as rep:
        state, _ = eng.run(state, steps=steps, schedule=schedules, key=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = _counts(kernels)
    want = dict.fromkeys(kernels, 0)
    want.update(langevin_update=len(tree_leaves(state.params)) * steps,
                wicon_read=len(tree_leaves(state.params)) * steps)
    check(got == want, f"tooling: guarded commits launched {got}, want {want}")
    log(f"tooling: {steps} fused W-Icon commits of {C} chains under "
        f"transfer_guard='error' passed in {wall:.3f} s; launches {got}")
    raised = None
    try:
        with instrument(transfer_guard="error"):
            engine(True).run(state, steps=steps, schedule=schedules, key=0)
    except RuntimeError as e:
        raised = str(e).splitlines()[0][:160]
    check(raised is not None, "tooling: the health_check commits read the flags back "
          "under transfer_guard='error' and did not raise")
    log(f"tooling: the same commits under health_check raised: {raised}")
    tl = _timeline("cluster", cluster_timeline(schedules, max_chains=None))
    del state, eng
    return {"launches": got, "wall_s": wall, "guarded_ms_per_commit": wall * 1e3 / steps,
            "report": rep.to_dict(), "health_check_raised": raised, "timeline": tl}


def tooling_prefetch(torch, np, kernels) -> dict:
    """(3) The launcher's training cell at TOOLING_LAYERS layers, one run
    fed by ``Prefetcher`` (batches made on a thread, copied from pinned
    memory on a side stream) and one without it, in this call: the batches
    bitwise the same, ms a commit of each (the second chunk), and the share
    of the batch time hidden — one minus the training thread's time getting
    a prefetched batch over its time making one inline."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.data import Prefetcher, make_batch
    from repro_torch.kernels import rng
    from repro_torch.launch import train as launch
    from repro_torch.utils import tree_leaves

    args = launch.parser().parse_args(
        ["--arch", "qwen3-4b", "--layers", str(TOOLING_LAYERS), "--seq", "128",
         "--mode", "inconsistent", "--fused", "--tau", "2", "--batch", "8",
         "--steps", str(PREFETCH_STEPS), "--chunk", str(PREFETCH_CHUNK)])
    cfg, _, state, engine, delays = launch.build(args)
    shape = ShapeConfig("cli", seq_len=args.seq, global_batch=args.batch, kind="train")

    def batch_fn(key):
        return make_batch(cfg, shape, torch.Generator().manual_seed(rng.seed_int(key)),
                          "train")

    def host_batches(key):
        while True:
            key, sub = rng.split(key)
            yield batch_fn(sub)

    out = {}
    seen, fetch = {}, {}
    for name in ("prefetched", "inline", "prefetched_again"):
        pf = None
        if name.startswith("prefetched"):
            pf = Prefetcher(batch_fn, rng.PRNGKey(7), device="cuda", depth=PREFETCH_CHUNK)
            source = pf
        else:
            source = host_batches(rng.PRNGKey(7))
        seen[name], fetch[name] = [], []

        def draw(_gen, source=source, rec=seen[name], waited=fetch[name]):
            t = time.perf_counter()
            b = next(source)  # inline: made here; prefetched: waited for
            waited.append(time.perf_counter() - t)
            rec.append(b["tokens"])
            return b

        ends = []

        def timer(_end, _state, _aux):
            torch.cuda.synchronize()
            ends.append(time.perf_counter())

        engine.batch_fn = draw
        engine.hooks = [timer]
        _reset(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = engine.run(state, steps=PREFETCH_STEPS, delays=delays, key=0)
        if pf is not None:
            pf.close()
        ms = (ends[-1] - ends[0]) * 1e3 / (PREFETCH_STEPS - PREFETCH_CHUNK)
        out[name] = {"ms_per_commit": ms, "first_chunk_s": ends[0] - t0,
                     "launches": _counts(kernels),
                     "batch_ms": sum(fetch[name]) * 1e3 / PREFETCH_STEPS}
        n = len(tree_leaves(state.params)) * PREFETCH_STEPS
        want = dict(dict.fromkeys(kernels, 0), langevin_update=n, wicon_read=n)
        check(out[name]["launches"] == want,
              f"tooling: training {name} launched {out[name]['launches']}, want {want}")
        log(f"tooling: training {name}: {ms:.2f} ms/commit after the first chunk "
            f"({ends[0] - t0:.3f} s), {out[name]['batch_ms']:.4f} ms a commit on the "
            f"host getting its batch; launches {out[name]['launches']}")
    same = all(torch.equal(a.cpu(), b.cpu()) for name in ("prefetched", "prefetched_again")
               for a, b in zip(seen[name], seen["inline"]))
    check(same and all(len(v) == PREFETCH_STEPS for v in seen.values()),
          "tooling: prefetched batches differ from the inline ones")
    pf_ms = (out["prefetched"]["batch_ms"] + out["prefetched_again"]["batch_ms"]) / 2
    hidden = 1.0 - pf_ms / out["inline"]["batch_ms"]
    out["hidden_share"] = hidden
    log(f"tooling: prefetched batches bitwise the inline ones; the training thread "
        f"spends {out['inline']['batch_ms']:.4f} ms a commit making its batch inline, "
        f"{pf_ms:.4f} waiting for a prefetched one: {hidden:.3f} of the batch time hidden")
    del state, engine
    return out


def tooling_roofline(torch, np, tp: dict) -> dict:
    """(4) The train cell's mfu from phase 6's measured ms a commit; a
    ``--all`` dry run on meta, timed; at depth 1 the FLOPs counted on the
    card for one real training step equal the dry run's at its shape."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.data import make_batch
    from repro_torch.kernels import rng
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.flop_cost import step_cost
    from repro_torch.launch.steps import build_model, make_sgld_train_step
    from repro_torch.models.transformer import init_params

    cfg = get_arch("qwen3-4b")
    cell = ShapeConfig("train_cell", seq_len=128, global_batch=8, kind="train")
    mf = roofline.model_flops(cfg, cell)
    mfu = roofline.mfu(mf, tp["ms_per_commit"] / 1e3)
    log(f"tooling: train cell {cfg.name} {cfg.active_param_count() / 1e9:.3f} B x "
        f"{8 * 128} tokens: model_flops {mf:.4g}, {tp['ms_per_commit']:.2f} ms a commit "
        f"(phase 6) -> mfu {mfu:.4f} against {roofline.PEAK_FLOPS:.4g} FLOP/s "
        f"({roofline.CARD})")
    t0 = time.perf_counter()
    rc = dryrun.main(["--all", "--out", str(TOOLING_OUT / "dryrun")])
    dry_s = time.perf_counter() - t0
    check(rc == 0, "tooling: the --all dry run failed")
    log(f"tooling: --all dry run on meta (40 combinations) in {dry_s:.1f} s")
    one = replace(cfg, num_layers=1)
    meta_step, meta_args, _, _ = dryrun.step_and_args(one, cell)
    meta = step_cost(meta_step, *meta_args)
    model, _ = build_model(one, cell, device="cuda")
    params = init_params(one, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda", num_chains=1)
    batch = make_batch(one, cell, torch.Generator().manual_seed(0))
    real = step_cost(make_sgld_train_step(model, cell), params, batch, rng.PRNGKey(0))
    check((real.flops, real.matmul_flops) == (meta.flops, meta.matmul_flops),
          f"tooling: FLOPs on the card {real.flops:.6g} / {real.matmul_flops:.6g} "
          f"against the dry run's {meta.flops:.6g} / {meta.matmul_flops:.6g}")
    log(f"tooling: depth 1, {cell.global_batch} x {cell.seq_len}: one training step "
        f"counts {real.flops:.6g} FLOPs ({real.matmul_flops:.6g} in matmuls) on the "
        f"card, as on meta; bytes {real.bytes:.4g} (card) / {meta.bytes:.4g} (meta)")
    del params, model
    return {"model_flops": mf, "ms_per_commit": tp["ms_per_commit"], "mfu": mfu,
            "peak_flops": roofline.PEAK_FLOPS, "dryrun_all_s": dry_s,
            "depth1_flops": real.flops, "depth1_matmul_flops": real.matmul_flops,
            "depth1_bytes_card": real.bytes, "depth1_bytes_meta": meta.bytes}


def tooling_path(torch, np, ds, kernels, tp: dict) -> dict:
    """Phase 12: (1) the instrumented decode / paged streams and their
    timelines, (2) the guarded cluster commits, (3) the prefetcher, (4) the
    roofline and the dry run."""
    from repro_torch.configs import get_arch

    cfg = replace(get_arch("qwen3-4b"), num_layers=TOOLING_LAYERS)
    log(f"tooling: {cfg.name} at its published widths, depth cut 36 -> {TOOLING_LAYERS}")
    out = {"layers": TOOLING_LAYERS, "streams": tooling_streams(torch, np, ds, cfg)}
    _free(torch)
    out["cluster"] = tooling_cluster(torch, np, kernels, cfg)
    _free(torch)
    out["prefetch"] = tooling_prefetch(torch, np, kernels)
    _free(torch)
    out["roofline"] = tooling_roofline(torch, np, tp)
    _free(torch)
    return out


def main() -> int:
    try:
        import numpy as np
        import torch
        import torch.nn.functional as F
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout (src/repro_torch "
              "is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_step as ds
    from repro_torch.kernels import delay_gather as dg
    from repro_torch.kernels import langevin_update as lu
    from repro_torch.kernels import ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    logs = build.build()
    log(f"built {', '.join(build.sources())} with nvcc for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in "\n".join(logs.values()).splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("ptxas:", line.strip(), file=sys.stderr)

    dec = {}
    for dtype in (torch.bfloat16, torch.float32):
        for smax, n_valid, slot in RING_CASES:
            timed = dtype == torch.bfloat16
            dec[(dtype, smax)] = run_decode_case(
                torch, F, ds, ref, dtype, smax, n_valid, slot, timed,
                plain_iters=5 if smax > 4096 else 50)
            torch.cuda.empty_cache()
    pag = {}
    for dtype in (torch.bfloat16, torch.float32):
        for pos, maxp in PAGED_CASES:
            pag[(dtype, maxp)] = run_paged_case(
                torch, F, ds, ref, dtype, dtype == torch.bfloat16, pos=pos,
                maxp=maxp, plain_iters=5 if maxp > 16 else 50)
            torch.cuda.empty_cache()
    # a group of 3 (the 110M example model's heads): the decode cell's ring
    # and the paged cell, both dtypes timed
    g3 = {}
    for dtype in (torch.bfloat16, torch.float32):
        g3[("ring", dtype)] = run_decode_case(torch, F, ds, ref, dtype, *RING_CASES[0],
                                              True, heads=LM100M_HEADS)
        g3[("paged", dtype)] = run_paged_case(torch, F, ds, ref, dtype, True,
                                              heads=LM100M_HEADS)
    # the model zoo's shapes (head_dim 112 and 160, a group of 7): the
    # decode cell's ring and the paged cell, both dtypes timed
    zc = {}
    for arch, heads in ZOO_HEADS.items():
        for dtype in (torch.bfloat16, torch.float32):
            zc[("ring", arch, dtype)] = run_decode_case(
                torch, F, ds, ref, dtype, *RING_CASES[0], True, heads=heads)
            zc[("paged", arch, dtype)] = run_paged_case(torch, F, ds, ref, dtype,
                                                        True, heads=heads)
    # hymba-1.5b's group of 5 (25 query heads over 5 KV heads, head_dim 64):
    # the decode cell's ring, the rings hymba's serving gives the kernel
    # (phase 11) and the paged cell, both dtypes timed
    g5 = {}
    for dtype in (torch.bfloat16, torch.float32):
        g5[("ring", dtype)] = [run_decode_case(torch, F, ds, ref, dtype, *RING_CASES[0],
                                               True, heads=HYMBA_HEADS)]
        g5[("ring", dtype)] += [run_decode_case(torch, F, ds, ref, dtype, smax, n_valid,
                                                slot, True, heads=HYMBA_HEADS, N=N)
                                for smax, n_valid, slot, N in HYMBA_RING_CASES]
        g5[("paged", dtype)] = run_paged_case(torch, F, ds, ref, dtype, True,
                                              heads=HYMBA_HEADS)
    torch.cuda.empty_cache()
    lang = run_langevin_checks(torch, np, lu, ref)
    wic, gat, dly = run_gather_checks(torch, np, dg, ref)
    torch.cuda.empty_cache()
    chains = run_chain_checks(torch, np, lu, dg, ref)
    masks = run_mask_checks(torch, np, lu, dg, ref)
    reference_check(torch, np)
    training_reference_check(torch, np, lu, dg)
    from repro_torch.configs import get_arch

    mp = main_path(torch, np, ds, get_arch("qwen3-4b"))
    gc.collect()  # the serving bank and engines went out of scope
    torch.cuda.empty_cache()
    log(f"serving bank freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        "still allocated")
    tp = train_path(torch, np, lu, dg)
    gc.collect()  # the training chain and its ring went out of scope
    torch.cuda.empty_cache()
    tl = train_lm_decode(torch, np, ds)
    sgld_kernels = {"langevin_update": lu.langevin_update, "wicon_read": dg.wicon_read,
                    "delay_gather": dg.delay_gather,
                    "coordinate_delays": dg.coordinate_delays}
    paper_reference_check(np, sgld_kernels)
    pf = paper_fused_check(np, sgld_kernels)
    pp = paper_path(torch, np, sgld_kernels)
    ca = cluster_reference_check(torch, np, sgld_kernels)
    cq = cluster_quickstart(torch, np, sgld_kernels)
    sq = serve_quickstart(torch, np, sgld_kernels, ds)
    gc.collect()
    torch.cuda.empty_cache()
    cp = cluster_path(torch, np, sgld_kernels, keep=(0, 3))
    gc.collect()
    torch.cuda.empty_cache()
    fa = cluster_fault_check(torch, np, sgld_kernels)
    fb = cluster_fault_path(torch, np, sgld_kernels, cp)
    del cp["final"]
    fc = run_checkpoint_path(torch, np, sgld_kernels)
    _free(torch)
    zoo = [zoo_config(torch, np, ds, arch) for arch in ZOO_DEPTH]
    srv = moe_serve_path(torch, np, ds)
    zt = [train_path(torch, np, lu, dg, ("--arch", "phi3.5-moe-42b-a6.6b", "--layers",
                                         str(MOE_TRAIN_LAYERS), "--seq", "128"),
                     cut=f"depth 32 -> {MOE_TRAIN_LAYERS}"),
          train_path(torch, np, lu, dg, ("--arch", "internvl2-1b", "--seq", "384"))]
    zoo_train = {"launches": {k: sum(r["launches"][k] for r in zt)
                              for k in zt[0]["launches"]}}
    _free(torch)
    # phase 11: the recurrent configs
    t11 = time.perf_counter()
    rref = recurrent_reference_check(torch, np, lu, dg, ds)
    rsrv = [recurrent_serve(torch, np, ds, "hymba-1.5b"),
            recurrent_serve(torch, np, ds, "xlstm-1.3b", gate="layers")]
    hwin = hymba_window(torch, np, ds)
    rtrain = [train_path(torch, np, lu, dg, ("--arch", arch, "--seq", "128", "--gamma",
                                             RECURRENT_TRAIN_GAMMA[arch]))
              for arch in ("hymba-1.5b", "xlstm-1.3b")]
    _free(torch)
    sloop = slstm_launches(torch)
    xgrad = xlstm_grad_scale(torch, np)
    phase11_s = time.perf_counter() - t11
    log(f"phase 11: {phase11_s:.1f} s; the script so far {time.perf_counter() - T_START:.1f} s "
        "of its 1,200")
    hybrid_train = {"launches": {k: sum(r["launches"][k] for r in rtrain)
                                 for k in rtrain[0]["launches"]}}
    hybrid = {"serve": rsrv[0]["launches"], "window": hwin["launches"]}
    # phase 12: the tooling
    t12 = time.perf_counter()
    tool = tooling_path(torch, np, ds, sgld_kernels, tp)
    phase12_s = time.perf_counter() - t12
    log(f"phase 12: {phase12_s:.1f} s; the script so far {time.perf_counter() - T_START:.1f} s "
        "of its 1,200")
    tool_runs = [tool["cluster"]] + [tool["prefetch"][n] for n in
                                     ("prefetched", "inline", "prefetched_again")]
    tooling_train = {"launches": {k: sum(r["launches"][k] for r in tool_runs)
                                  for k in sgld_kernels}}
    tool_decode = tool["streams"]["decode"]["launches"]["decode_step"]
    tool_paged = tool["streams"]["paged"]["launches"]["paged_decode_step"]

    def cases(runs):
        return [{k: r[k] for k in ("dtype", "heads", "rows", "smax", "valid", "maxp", "pos",
                                   "splits",
                                   "max_abs_err", "limit", "ms", "eager_ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms",
                                   "library_eager_ms") if k in r}
                for r in runs]

    d, p = dec[(torch.bfloat16, 256)], pag[(torch.bfloat16, 16)]
    kernels = [
        {"name": "decode_step", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/decode_step.cuh",
         "replaces": "src/repro/kernels/decode_step.py:63",
         "launches": (mp["decode"]["launches"] + mp["serve"]["decoder"]["launches"]
                      + tl["launches"] + sum(z["launches"] for z in zoo)
                      + srv["decode"]["launches"] + sum(hybrid.values()) + tool_decode),
         "launches_by_path": {"decode": mp["decode"]["launches"],
                              "serve_decoder": mp["serve"]["decoder"]["launches"],
                              "train_lm_decode_group3": tl["launches"],
                              "zoo": {z["arch"]: z["launches"] for z in zoo},
                              "moe_serve": srv["decode"]["launches"],
                              "hybrid": hybrid, "tooling": tool_decode},
         "max_abs_err": d["max_abs_err"],
         "ms": d["ms"], "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
         "bound_by": d["bound_by"], "library_ms": d["library_ms"],
         "cases": cases(dec[(torch.bfloat16, n)] for n in (256, 1024, 16384)),
         "group3_cases": cases(g3[("ring", t)] for t in (torch.bfloat16, torch.float32)),
         "zoo_cases": cases(zc[("ring", a, t)] for a in ZOO_HEADS
                            for t in (torch.bfloat16, torch.float32)),
         "group5_cases": cases(r for t in (torch.bfloat16, torch.float32)
                               for r in g5[("ring", t)]),
         "group5_held": {k: r["held"] for k, r in (("serve", rsrv[0]), ("window", hwin))}},
        {"name": "paged_decode_step", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/decode_step.cuh",
         "replaces": "src/repro/kernels/decode_step.py:150",
         "launches": (mp["paged"]["launches"] + srv["paged"]["launches"]
                      + sum(z["paged"]["launches"] for z in zoo if "paged" in z)
                      + tool_paged),
         "launches_by_path": {"paged": mp["paged"]["launches"],
                              "zoo": {z["arch"]: z["paged"]["launches"]
                                      for z in zoo if "paged" in z},
                              "moe_serve": srv["paged"]["launches"],
                              "tooling": tool_paged},
         "max_abs_err": p["max_abs_err"],
         "ms": p["ms"], "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"],
         "bound_by": p["bound_by"], "library_ms": p["library_ms"],
         "cases": cases(pag[(torch.bfloat16, n)] for n in (16, 256)),
         "group3_cases": cases(g3[("paged", t)] for t in (torch.bfloat16, torch.float32)),
         "zoo_cases": cases(zc[("paged", a, t)] for a in ZOO_HEADS
                            for t in (torch.bfloat16, torch.float32)),
         "group5_cases": cases(g5[("paged", t)] for t in (torch.bfloat16, torch.float32))},
    ]
    # the delay_gather entry is the one W-Icon kernel: its numbers and
    # launches are the main path's instantiation (wicon_read, delays drawn
    # in the kernel), both instantiations under "cases"
    # an SGLD kernel's launches on each main path: training (phase 6), the
    # paper's experiments at their published settings (phase 7c) and the
    # fused preset inside the regression chain (7b); "launches" is their sum
    # "cluster": the launches on phase 8c's full-width 4-chain ensemble; the
    # kernels take every path's chains in one launch (1 chain on the
    # others), the 4- and 32-chain cases are under "chain_cases"
    # (the W-Icon kernel's launches are its two instantiations' together:
    # the one-pass read, and the gather of the unfused read)
    for name, src, replaces, r, counters, chain_case in (
            ("langevin_update", "langevin_update.cu",
             "src/repro/kernels/langevin_update.py:45", lang, ("langevin_update",),
             "update"),
            ("delay_gather", "delay_gather.cu",
             "src/repro/kernels/delay_gather.py:33", wic, ("wicon_read", "delay_gather"),
             "read"),
            # not a Pallas kernel: the jax.random.randint of the W-Icon read
            ("coordinate_delays", "delay_gather.cu",
             "src/repro/core/delay.py:118", dly, ("coordinate_delays",), "draw")):
        by_path = {path: sum(run["launches"][k] for k in counters)
                   for path, run in (("train", tp), ("paper", pp), ("paper_fused", pf),
                                     ("cluster", cp), ("faults", fa), ("fault_path", fb),
                                     ("run_checkpoint", fc), ("zoo_train", zoo_train),
                                     ("hybrid_train", hybrid_train),
                                     ("tooling", tooling_train))}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}", "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "chain_cases": chains[chain_case]
            + (chains["gather"] if chain_case == "read" else [])})
    kernels[2]["masked_cases"] = masks
    kernels[-2]["cases"] = [
        {k: r[k] for k in ("entry", "max_abs_err", "ms", "plain_ms", "bound_ms",
                           "bound_by", "library_ms")} for r in (wic, gat)]
    log(json.dumps({"paper": {k: v for k, v in pp.items() if k != "launches"}}))
    log(json.dumps({"cluster": {"reference": ca, "quickstart": cq, "full_width": cp}}))
    log(json.dumps({"serve": {**mp["serve"], "quickstart": sq}}))
    log(json.dumps({"faults": {"chaos": fa, "full_width": fb, "run_checkpoint": fc}}))
    log(json.dumps({"zoo": {"configs": zoo, "moe_serve": srv, "train": zt}}))
    log(json.dumps({"recurrent": {"reference": rref, "serve": rsrv, "window": hwin,
                                  "train": rtrain, "slstm_loop": sloop,
                                  "xlstm_grad_at_init": xgrad, "seconds": phase11_s}}))
    log(json.dumps({"tooling": {**tool, "seconds": phase12_s}}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
