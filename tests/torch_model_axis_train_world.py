"""One rank of a gloo world that trains a chain split over the ``model``
axis with the port's SGLD step builders on the CPU, and holds what it got
against the JAX package's unplaced step, for
``tests/test_torch_model_axis_train.py``.

    python tests/torch_model_axis_train_world.py RANK WORLD STORE OUT FIXTURES

``STORE`` is the ``FileStore`` path the ranks meet at, ``OUT`` a directory
for the results (every rank writes ``world<WORLD>_rank<RANK>.pkl``),
``FIXTURES`` the directory holding each case's parameters and ``pending``
(``<case>.npz``, ``<case>_pending.npz``: drawn by the JAX package, a bank
of one in the port's layout) and tokens (``<case>_tokens.npy``).  The JAX
package's results (``<case>_d<D>_oracle.npz`` and ``..._loss.npy``, D the
data shards: the unplaced step, or for a MoE over ``data`` 2 the unplaced
step on each shard's rows, averaged) are written by the test while the
worlds run; a rank waits for the ``.done`` marker beside them.

A world of 2 ranks trains over ``data`` 1 x ``model`` 2; a world of 4 over
``data`` 2 x ``model`` 2, then ``data`` 1 x ``model`` 4, then ``pod`` 2 x
``data`` 1 x ``model`` 2.  The FSDP cases: ``fsdp_full`` (every weight over
every axis, the batch too; at a global batch of 8 each microbatch's rows
split over the four ranks, at 4 each rank its one row of the batch) and
kimi-k2's own ``fsdp_tp`` (its experts' ``d_ff`` over ``data``).  Each case
runs one ``sync`` and one ``pipeline`` step on the placed chain; every rank
reports each leaf's block against the oracle's (the gradient's relative
L2, the new parameters' largest difference), its noise block against the
block of the port's unplaced ``noise_like(..., noise="jax")``, bit for
bit, its loss, its local shapes and placements, the refusals of
``noise="torch"``, the collectives a step, and FSDP's gathered bytes alive
at most against one layer's leaves and the embedding and the head.  The
world of 4 also rehearses ``chip_smoke.py`` phase 15's cells at the
reduced widths.  When run as a script, this process imports no JAX.
"""

import os
import pickle
import sys
import time
import traceback
from dataclasses import replace

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: case -> (reduced config, its changes); kimi-k2's config is ``fsdp_tp``
CASES = {
    "qwen3": ("qwen3-4b", {}),
    "head-shard": ("qwen3-4b", {"opt_attn_head_shard": True}),
    "heads6": ("qwen3-4b", {"num_heads": 6}),
    "vocab511": ("qwen3-4b", {"vocab_size": 511}),
    "phi-moe": ("phi3.5-moe-42b-a6.6b", {}),
    "kimi-moe": ("kimi-k2-1t-a32b", {}),
    "fsdp": ("qwen3-4b", {"param_sharding": "fsdp_full"}),
    "fsdp-b4": ("qwen3-4b", {"param_sharding": "fsdp_full"}),
    "hymba": ("hymba-1.5b", {}),
    # 5 heads of 128 SSD channels: model 2 cuts a head (2.5 a rank), as 25
    # heads on 2 or 16 do at the published widths; its attention replicated
    "hymba-cut": ("hymba-1.5b", {"d_model": 320, "num_heads": 5, "num_kv_heads": 5}),
    "xlstm": ("xlstm-1.3b", {}),
    "internvl2": ("internvl2-1b", {}),
    "musicgen": ("musicgen-medium", {}),
}
#: the configs with a layout of their own: decoded through the placed
#: ``Model.serve_step`` against the unplaced one, and the engines' refusals
OWN_LAYOUTS = ("hymba", "hymba-cut", "xlstm", "internvl2", "musicgen")
FRONTEND_N = 8  # stub positions of a frontend config's batch
DECODE = (2, 6)  # rows and tokens decoded by replay (after the stub positions)
MOE = ("phi-moe", "kimi-moe")
FSDP = ("fsdp", "fsdp-b4", "kimi-moe")
#: world -> the meshes it trains over (``(data, model)``, or ``(pod, data,
#: model)``), each with its cases
MESHES = {
    2: [((1, 2), ["qwen3", "head-shard", "heads6", "vocab511", "phi-moe", "kimi-moe",
                  "hymba", "hymba-cut", "xlstm", "internvl2", "musicgen"])],
    4: [((2, 2), ["qwen3", "phi-moe", "kimi-moe", "fsdp", "fsdp-b4", "hymba", "xlstm",
                  "internvl2"]),
        ((1, 4), ["qwen3", "head-shard", "heads6", "vocab511", "phi-moe", "hymba",
                  "hymba-cut", "internvl2", "musicgen"]),
        ((2, 1, 2), ["fsdp"])],
}
#: chip_smoke.py phase 15's cells rehearsed on the CPU over data 2 x model 2:
#: (name, reduced config, dtype, its gates: loss rtol, gradient rel L2,
#: new parameters' atol, the layouts trained beside the tensor-parallel one)
PHASE15 = (("phi3.5-moe", "phi3.5-moe-42b-a6.6b", "bfloat16", (1e-2, 0.05, None),
            ("fsdp_tp",)),
           ("qwen3-4b-f32", "qwen3-4b", "float32", (1e-5, 1e-4, 1e-6), ("fsdp_full",)),
           ("hymba-1.5b", "hymba-1.5b", "bfloat16", (1e-2, 0.05, None), ()),
           ("xlstm-1.3b", "xlstm-1.3b", "float32", (1e-5, 0.05, 1e-6), ()))
SEQ, BATCH, MICRO = 64, 4, 2  # the reference test's step: seq_len 64, batch 4, 2 microbatches
BATCHES = {"fsdp": 8}  # a case's global batch, where it is not BATCH
GAMMA, SIGMA = 1e-3, 1e-4
KEYS = {"sync": 3, "pipeline": 4}  # PRNGKey seeds of the two steps' noise
ORACLE_WAIT = 480  # seconds a rank waits for the JAX package's results


def config(case, get_reduced):
    arch, changes = CASES[case]
    return replace(get_reduced(arch), dtype="float32", **changes)


def batch_of(case):
    return BATCHES.get(case, BATCH)


def axis_names(shape):
    return ("pod", "data", "model")[-len(shape):]


def mesh_of(shape):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(shape),
                      mesh_dim_names=axis_names(shape))


def shards(case, shape):
    """The data shards the oracle averages over: a MoE's capacity is a
    shard's, a dense model does not notice the split."""
    return shape[0] if case in MOE else 1


def oracle_case(case):
    """The case whose JAX results ``case`` is held against: the head-sharded
    layout and ``fsdp_full`` at qwen3's batch are qwen3's unplaced step (the
    reference's switches act only on a mesh)."""
    return "qwen3" if case in ("head-shard", "fsdp-b4") else case


def oracle_name(case, d):
    return f"{oracle_case(case)}_d{d}"


def _wait(path):
    deadline = time.monotonic() + ORACLE_WAIT
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path} after {ORACLE_WAIT} s")
        time.sleep(0.2)


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def train_case(case, mesh, shape, fixtures) -> dict:
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.checkpoint.io import leaf_paths
    from repro_torch.configs import ShapeConfig, get_reduced
    from repro_torch.kernels import rng
    from repro_torch.launch.steps import (
        batch_specs,
        build_model,
        make_sgld_train_step,
        place_params,
    )
    from repro_torch.models import common
    from repro_torch.models.transformer import init_params
    from repro_torch.samplers.transforms import noise_like
    from repro_torch.utils import block_slices, gather_chains, local

    cfg = config(case, get_reduced)
    step_shape = ShapeConfig("t", SEQ, batch_of(case), "train", num_microbatches=MICRO)
    model, _ = build_model(cfg, step_shape, device="cpu", mesh=mesh)
    like = init_params(cfg, device="meta", num_chains=1)
    whole = restore_checkpoint(os.path.join(fixtures, f"{case}.npz"), like, device="cpu")
    pend = restore_checkpoint(os.path.join(fixtures, f"{case}_pending.npz"), like,
                              device="cpu")
    tokens = torch.from_numpy(np.load(os.path.join(fixtures, f"{case}_tokens.npy")))
    batch = {"tokens": tokens}
    if cfg.frontend:
        batch["frontend"] = torch.from_numpy(
            np.load(os.path.join(fixtures, f"{case}_frontend.npy")))
    params, pending = place_params(whole, model), place_params(pend, model)

    got = {"heads": model.tp.heads, "summed": sorted(model.tp.summed),
           "batch_axes": model.batch_axes,
           "axes": dict(zip(axis_names(shape), shape)),
           "batch_specs": {k: tuple(str(x) for x in pl) for k, pl in
                           batch_specs(cfg, step_shape, mesh, model.batch_axes)[1].items()}}
    common.reset_collectives()
    sync = make_sgld_train_step(model, step_shape, "sync", GAMMA, SIGMA)
    new_sync, loss_sync = sync(params, batch, rng.PRNGKey(KEYS["sync"]))
    got["collectives"] = dict(common.COLLECTIVES)
    # FSDP's gathered bytes alive at most, against one layer's leaves (the
    # largest) and the embedding and the head, whole
    layer = max(sum(t.numel() * t.element_size() // t.shape[1]
                    for p, t in leaf_paths(whole) if p.startswith("stack")), 0)
    top = sum(t.numel() * t.element_size() for p, t in leaf_paths(whole)
              if p.split("##")[0] in ("embed", "lm_head"))
    got["gathered"] = {"peak": common.GATHERED["peak"], "layer_and_ends": layer + top,
                       "model": sum(t.numel() * t.element_size()
                                    for _, t in leaf_paths(whole))}
    pipe = make_sgld_train_step(model, step_shape, "pipeline", GAMMA, SIGMA)
    new_pipe, grads, loss_pipe = pipe(params, pending, batch, rng.PRNGKey(KEYS["pipeline"]))
    got["loss"] = {"sync": loss_sync.item(), "pipeline": loss_pipe.item()}

    # the noise: each rank's block against the port's unplaced draw's block
    scale = (2.0 * SIGMA * GAMMA) ** 0.5
    key = rng.PRNGKey(KEYS["sync"])
    placed_noise = noise_like(key, params, scale, torch.float32, "jax")
    whole_noise = noise_like(key, whole, scale, torch.float32, "jax")
    got["noise_bitwise"] = {
        p: torch.equal(n.to_local(), w[block_slices(n.shape, n.device_mesh, n.placements)])
        for (p, n), (_, w) in zip(leaf_paths(placed_noise), leaf_paths(whole_noise))}

    # what each rank holds: placements, local and global shapes of each tree
    got["held"] = {
        p: (tuple(str(x) for x in t.placements), tuple(t.shape),
            {name: tuple(tree_leaf.to_local().shape) for name, tree_leaf in
             (("params", t), ("grads", g), ("noise", n), ("new", s))})
        for (p, t), (_, g), (_, n), (_, s) in zip(
            leaf_paths(params), leaf_paths(grads), leaf_paths(placed_noise),
            leaf_paths(new_sync))}

    # the refusals
    got["refused"] = {}
    for what, call in (("step", lambda: make_sgld_train_step(model, step_shape, "sync",
                                                             noise="torch")),
                       ("noise_like", lambda: noise_like(key, params, scale,
                                                         torch.float32, "torch"))):
        try:
            call()
            got["refused"][what] = None
        except ValueError as e:
            got["refused"][what] = str(e)

    # against the JAX package's step
    name = oracle_name(case, shards(case, shape))
    _wait(os.path.join(fixtures, name + ".done"))
    ref = restore_checkpoint(os.path.join(fixtures, name + "_oracle.npz"),
                             {"grads": like, "sync": like, "pipeline": like}, device="cpu")
    got["loss_ref"] = float(np.load(os.path.join(fixtures, name + "_loss.npy")))
    got["grads"], got["new"] = {}, {}
    for (p, g), (_, rg) in zip(leaf_paths(grads), leaf_paths(ref["grads"])):
        got["grads"][p] = _rel_l2(g.to_local(), rg[block_slices(g.shape, g.device_mesh,
                                                                g.placements)])
    for mode, new in (("sync", new_sync), ("pipeline", new_pipe)):
        for (p, t), (_, rt) in zip(leaf_paths(new), leaf_paths(ref[mode])):
            blk = rt[block_slices(t.shape, t.device_mesh, t.placements)]
            got["new"][(mode, p)] = float((t.to_local() - blk).abs().max())
    # the new parameters gathered whole: every rank's blocks put together
    got["gathered_whole"] = max(float((a - b).abs().max()) for (_, a), (_, b) in zip(
        leaf_paths(gather_chains(new_sync)), leaf_paths(ref["sync"])))
    got["local_tree"] = all(not hasattr(t, "placements") for t in
                            [x for _, x in leaf_paths(local(new_sync))])
    if case in OWN_LAYOUTS:
        got.update(own_layout(cfg, model, whole, params, batch, mesh, fixtures))
    return got


def _decode(model, params, batch):
    """Log-probs ``(B, T, V)`` float64 of :data:`DECODE`'s tokens fed one by
    one through ``model.serve_step`` (teacher-forced), the rank's
    vocabulary slices gathered; a frontend config's stub positions (and the
    first token) prefilled into a cache with room for the rest, as a caller
    of ``init_cache`` prefills them."""
    B, T = DECODE
    tokens = batch["tokens"][:B, :T]
    out = []
    if model.cfg.frontend:
        fe = batch["frontend"][:B]
        logits, pre = model.prefill(params, {"frontend": fe, "tokens": tokens[:, :1]})
        S = pre["attn"]["k"].shape[3]
        cache = model.init_cache(B, S + T, prefill_len=S)
        for name in ("k", "v"):
            cache["attn"][name][:, :, :, :S] = pre["attn"][name]
        out.append(logits)
        start, first = S, 1
    else:
        cache = model.init_cache(B, 2 * T)
        start, first = 0, 0
    for t in range(first, T):
        logits, cache = model.serve_step(params, cache, tokens[:, t:t + 1], start + t - first)
        out.append(logits)
    logits = model.gather_vocab(torch.cat(out, dim=2)[0])
    return torch.log_softmax(logits.double(), dim=-1)


def own_layout(cfg, model, whole, params, batch, mesh, fixtures) -> dict:
    """A config with a layout of its own: decoding through the placed model
    against the unplaced one, the engines' refusals on the placed model, the
    rank's SSD channels and decode state, and the placed chain's round trip
    (``gather_rows``, ``gather_chains``, a placed checkpoint)."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.checkpoint.io import leaf_paths
    from repro_torch.cluster import DecodeEngine
    from repro_torch.models.transformer import Model
    from repro_torch.utils import gather_chains, gather_rows, local

    got = {}
    with torch.no_grad():
        placed = _decode(model, local(params), batch)
        unplaced = _decode(Model(cfg, device="cpu"), whole, batch)
    got["decode"] = float((placed - unplaced).abs().max())
    got["refused_bank"] = {}
    for what, call in (("init_cache_bank", lambda: model.init_cache_bank(1, 2, 8)),
                       ("DecodeEngine", lambda: DecodeEngine(cfg, whole, device="cpu", mesh=mesh,
                                                             shard_params=True))):
        try:
            call()
            got["refused_bank"][what] = None
        except ValueError as e:
            got["refused_bank"][what] = str(e)
    tp = model.tp
    got["ssm"] = (tp.ssm, sorted(tp.ssm_gather or {}))
    if cfg.block_pattern == ("hymba_mlp",):
        st = model.init_cache(2, 8)
        got["ssm_state"] = (tuple(st["ssm_h"].shape), tuple(st["ssm_conv"].shape))
    # the round trip: each placed leaf's blocks gathered over model, whole
    # chains gathered, and a placed checkpoint written and read back
    trip = {}
    for p, t in leaf_paths(params):
        pl = [x for x in t.placements if x.is_shard()]
        back = (gather_rows(t.to_local(), mesh, "model", pl[0].dim) if pl
                else t.to_local())
        trip[p] = torch.equal(back, dict(leaf_paths(whole))[p])
    whole_again = gather_chains(params)
    trip["gather_chains"] = all(torch.equal(a, b) for (_, a), (_, b) in
                                zip(leaf_paths(whole_again), leaf_paths(whole)))
    path = os.path.join(fixtures, f"placed_{cfg.name}_{mesh.mesh.numel()}_"
                        f"{'x'.join(map(str, mesh.mesh.shape))}.npz")
    save_checkpoint(path, params)
    saved = restore_checkpoint(path, whole, device="cpu")
    trip["checkpoint_whole"] = all(torch.equal(a, b) for (_, a), (_, b) in
                                   zip(leaf_paths(saved), leaf_paths(whole)))
    again = restore_checkpoint(path, params)
    trip["checkpoint_placed"] = all(
        torch.equal(a.to_local(), b.to_local()) and a.placements == b.placements
        for (_, a), (_, b) in zip(leaf_paths(again), leaf_paths(params)))
    got["round_trip"] = trip
    return got


def phase15_cells(mesh, rank, out):
    """``chip_smoke.py`` phase 15's cells on the CPU at the reduced widths:
    a sync and a pipeline step, each rank's results for the script's own
    report."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from repro_torch.configs import get_reduced

    res = {}
    for name, arch, dtype, tol, layouts in PHASE15:
        cfg = replace(get_reduced(arch), dtype=dtype)
        t0 = time.perf_counter()
        res[name] = chip_smoke.model_axis_train_cell(
            torch, np, cfg, mesh, rank, tol, device="cpu", batch=4, seq=16, micro=2,
            steps=(("sync", 1), ("pipeline", 1)), layouts=layouts,
            gamma=chip_smoke.TRAIN_AXIS_CELL_GAMMA.get(name, chip_smoke.TRAIN_AXIS_GAMMA))
        res[name]["cell_s"] = time.perf_counter() - t0
    out["phase15"] = res


def main() -> int:
    sys.modules["jax"] = None  # the port must not reach for JAX
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.launch.mesh import init_world

    rank, world, store, outdir, fixtures = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    init_world("cpu", store, rank=rank, world_size=world)
    out: dict = {}
    try:
        for shape, cases in MESHES[world]:
            mesh = mesh_of(shape)
            for case in cases:
                out[(shape, case)] = train_case(case, mesh, shape, fixtures)
            if shape == (2, 2):
                phase15_cells(mesh, rank, out)
    except BaseException:  # noqa: BLE001 — reported to the test, then re-raised
        out["error"] = traceback.format_exc()
        _dump(outdir, world, rank, out)
        raise
    _dump(outdir, world, rank, out)
    torch.distributed.destroy_process_group()
    return 0


def _dump(outdir, world, rank, out):
    with open(os.path.join(outdir, f"world{world}_rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    sys.exit(main())
