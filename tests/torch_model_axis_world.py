"""One rank of a gloo world that serves 2-D banks (chains x the ``model``
axis) from the port's decode engines on the CPU and writes what they gave,
for ``tests/test_torch_model_axis.py``.

    python tests/torch_model_axis_world.py RANK WORLD STORE OUT FIXTURES

``STORE`` is the ``FileStore`` path the ranks meet at, ``OUT`` a directory
for the results (every rank writes ``world<WORLD>_rank<RANK>.pkl``),
``FIXTURES`` the directory holding ``<case>.npz`` (each case's bank, drawn
by the JAX package, in the port's layout) and ``moe.npz`` (the expert-
parallel block's inputs).  A world of 2 ranks serves over ``data`` 1 x
``model`` 2; a world of 4 over ``data`` 2 x ``model`` 2 and then over
``data`` 1 x ``model`` 4, and runs the MoE block over ``data`` 2 x
``model`` 2 with the batch split over ``data``; the world of 2 also runs
``chip_smoke.py`` phase 14's MoE cell and its (d) — the frontend and
recurrent configs served by the placed ``Model.serve_step`` — on the CPU.  Rank 0 also runs the
unplaced engines on the whole bank.  Every rank reports its tokens, its
local shapes and its leaves' placements.  When run as a script, this
process imports no JAX.
"""

import os
import pickle
import sys
import traceback
from dataclasses import replace

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: case -> (reduced config, its changes, chains)
CASES = {
    "qwen3": ("qwen3-4b", {}, 4),
    "kimi-moe": ("kimi-k2-1t-a32b", {}, 2),
    "heads6": ("qwen3-4b", {"num_heads": 6}, 2),
    "vocab511": ("qwen3-4b", {"vocab_size": 511}, 2),
    "head-shard": ("qwen3-4b", {"opt_attn_head_shard": True}, 2),
}
#: world -> the (data, model) meshes it serves over, each with its cases
MESHES = {
    2: [((1, 2), ["qwen3", "kimi-moe", "vocab511", "head-shard"])],
    4: [((2, 2), ["qwen3", "kimi-moe"]),
        ((1, 4), ["qwen3", "kimi-moe", "heads6", "vocab511", "head-shard"])],
}
PROMPT = (3, 5)  # the decode request: 3 prompts of 5 tokens, 6 new tokens
NEW = 6
PAGED = [(5, 6), (3, 4), (7, 5)]  # (prompt length, new tokens), over 2 slots
#: chip_smoke.py phase 14 (d) at the reduced widths: (name, config, stub
#: positions, prompt tokens, new tokens)
REPLAY = (("internvl2-1b", "internvl2-1b", 8, 1, 4), ("hymba-1.5b", "hymba-1.5b", 0, 6, 4))


def config(case, get_reduced):
    arch, changes, _ = CASES[case]
    return replace(get_reduced(arch), dtype="float32", **changes)


def prompts(cfg):
    return np.random.default_rng(1).integers(0, cfg.vocab_size, PROMPT).astype(np.int32)


def paged_requests(cfg):
    gen = np.random.default_rng(0)
    return [(gen.integers(0, cfg.vocab_size, (t,)).astype(np.int32), n) for t, n in PAGED]


def serve(cfg, bank, mesh, shard):
    """The decode request through a DecodeEngine and the paged requests
    (one sampled) through a PagedDecodeEngine: -> (decode engine, paged
    engine, {"tokens", "logits", "paged": [(tokens, logits)]})."""
    from repro_torch.cluster import DecodeEngine, PagedDecodeEngine, Request

    kw = dict(device="cpu", mesh=mesh, shard_params=shard, return_logits=True)
    dec = DecodeEngine(cfg, bank, max_seq=32, **kw)
    res = dec.generate(prompts(cfg), NEW)
    pag = PagedDecodeEngine(cfg, bank, num_slots=2, page_size=8, max_seq=32,
                            decode_chunk=4, **kw)
    ids = [pag.submit(Request(tokens=t, max_new_tokens=n, key=None if i != 2 else 11))
           for i, (t, n) in enumerate(paged_requests(cfg))]
    done = {c.request_id: c for c in pag.drain()}
    return dec, pag, {"tokens": res.tokens, "logits": res.logits,
                      "paged": [(done[i].tokens, done[i].logits) for i in ids]}


def leaf_report(params) -> dict:
    """path -> (placements, local shape, global shape) of a placed tree."""
    from repro_torch.checkpoint.io import leaf_paths

    return {p.replace("##", "/"): (tuple(str(x) for x in t.placements),
                                   tuple(t.to_local().shape), tuple(t.shape))
            for p, t in leaf_paths(params)}


def serving(mesh, shape, cases, rank, fixtures, out):
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.configs import get_reduced
    from repro_torch.models.transformer import init_params
    from repro_torch.utils import gather_chains, tree_leaves

    for case in cases:
        cfg = config(case, get_reduced)
        like = init_params(cfg, device="meta", num_chains=CASES[case][2])
        path = os.path.join(fixtures, f"{case}.npz")
        bank = restore_checkpoint(path, like, device="cpu")
        dec, pag, got = serve(cfg, bank, mesh, True)
        cache = next(iter(dec._cache.values()))["attn"]
        got.update(params=leaf_report(dec.params), heads=dec._model.tp.heads,
                   cache=tuple(cache["k"].shape), pool=tuple(pag._pages["k"].shape),
                   whole=all(torch.equal(a, b) for a, b in zip(
                       tree_leaves(gather_chains(dec.params)), tree_leaves(bank))))
        if case == "qwen3":
            got.update(qwen3_extras(cfg, bank, path, mesh, shape, rank, dec))
        if rank == 0:
            got["ref"] = serve(cfg, bank, None, False)[2]
        out[(shape, case)] = got


def qwen3_extras(cfg, bank, path, mesh, shape, rank, dec) -> dict:
    """What the qwen3 case adds: the bank restored straight into the 2-D
    layout; the bank placed on the chain axis alone (a placed cluster's
    state) served 2-D through ``from_cluster``; the vocabulary-parallel
    lookup against the whole embedding's rows; ``param_structs``' placements;
    and on ``model`` 2 a 1,024-token prompt (the SDPA prefill path) against
    rank 0's unplaced engine."""
    from repro_torch.cluster import DecodeEngine
    from repro_torch.launch.steps import param_structs
    from repro_torch.models.transformer import Model, init_params
    from repro_torch.utils import chain_placements, local, local_block, place_chains

    got = {}
    restored = DecodeEngine.from_checkpoint(
        path, like=init_params(cfg, device="meta"), model=cfg, max_seq=32,
        device="cpu", mesh=mesh, shard_params=True, return_logits=True)
    r = restored.generate(prompts(cfg), NEW)
    got["restored"] = {"tokens": r.tokens, "logits": r.logits,
                       "params": leaf_report(restored.params)}
    rows = place_chains(_block(bank, mesh), mesh, "data")
    served = DecodeEngine.from_cluster(rows, cfg, max_seq=32, device="cpu",
                                       shard_params=True, return_logits=True)
    r = served.generate(prompts(cfg), NEW)
    got["from_cluster"] = {"tokens": r.tokens, "logits": r.logits,
                           "params": leaf_report(served.params)}
    model = Model(cfg, device="cpu", mesh=mesh)
    toks = torch.from_numpy(prompts(cfg))
    w = local(dec.params)["embed"]["w"]
    whole = bank["embed"]["w"][:, toks]
    got["lookup_bitwise"] = torch.equal(
        model._lookup(w, toks),
        local_block(whole, mesh, chain_placements(mesh, "data")))
    _, placements = param_structs(cfg, mesh)
    got["param_structs"] = {p.replace("##", "/"): tuple(str(x) for x in pl)
                            for p, pl in _spec_leaves(placements)}
    if shape == (1, 2):  # a 1,024-token prompt: the SDPA prefill
        long = np.random.default_rng(4).integers(0, cfg.vocab_size, (1, 1024)).astype(np.int32)
        kw = dict(max_seq=1040, device="cpu", return_logits=True)
        r = DecodeEngine(cfg, bank, mesh=mesh, shard_params=True, **kw).generate(long, 3)
        got["long"] = {"tokens": r.tokens, "logits": r.logits}
        if rank == 0:
            r = DecodeEngine(cfg, bank, **kw).generate(long, 3)
            got["long_ref"] = {"tokens": r.tokens, "logits": r.logits}
    return got


def _block(bank, mesh):
    from repro_torch.utils import chain_block, tree_map

    rows = chain_block(mesh, "data", CASES["qwen3"][2])
    return tree_map(lambda t: t[rows].clone(), bank)


def _spec_leaves(tree, prefix=""):
    """``[(path, placements)]`` of a tree of placement lists."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def phase14_cell(mesh, rank, out):
    """``chip_smoke.py`` phase 14's cell on the CPU: phi3.5-moe reduced in
    bf16, a 2-chain 2-D bank, the decode traffic against the unplaced
    engine under replayed routing and the teacher-forced forward."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import decode_step as ds

    cfg = replace(get_reduced("phi3.5-moe-42b-a6.6b"), dtype="bfloat16")
    out["phase14"] = chip_smoke.model_axis_cell(torch, np, ds, cfg, mesh, rank, 2, False,
                                                device="cpu")
    out["phase14_replay"] = {}
    for name, arch, stub, T, n in REPLAY:
        cfg = replace(get_reduced(arch), dtype="bfloat16")
        got = chip_smoke.model_axis_replay_cell(torch, np, ds, cfg, mesh, rank, 2, stub, T,
                                                n, device="cpu")
        got["cell_s"] = 0.0
        out["phase14_replay"][name] = got


def expert_parallel(mesh, fixtures, out):
    """The MoE block over ``data`` 2 x ``model`` 2: each rank its batch rows
    (``data``) and its experts and shared columns (``model``)."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import moe

    f = np.load(os.path.join(fixtures, "moe.npz"))
    cfg = replace(get_reduced("phi3.5-moe-42b-a6.6b"), dtype="float32",
                  num_shared_experts=int(f["shared"]))
    d, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    E, B = cfg.num_experts, f["x"].shape[0]
    e, b = E // 2, B // 2
    params = {}
    for k in f.files:
        if k in ("x", "shared"):
            continue
        a = torch.from_numpy(f[k])[None]
        if k in ("w_gate", "w_up", "w_down"):
            a = a[:, m * e:(m + 1) * e]
        elif k in ("shared_w_gate", "shared_w_up"):
            a = a[..., m * a.shape[-1] // 2:(m + 1) * a.shape[-1] // 2]
        elif k == "shared_w_down":
            a = a[:, m * a.shape[1] // 2:(m + 1) * a.shape[1] // 2]
        params[k] = a.contiguous()
    x = torch.from_numpy(f["x"][d * b:(d + 1) * b])[None]
    moe.reset_dropped()
    y, aux = moe.apply_moe(params, x, cfg, mesh=mesh, batch_axes=("data",))
    out["moe"] = {"rows": (d * b, (d + 1) * b), "y": y[0].numpy(),
                  "aux": float(aux[0]), "dropped": moe.dropped_pairs()}


def main() -> int:
    sys.modules["jax"] = None  # the port must not reach for JAX
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.launch.mesh import init_world, make_debug_mesh

    rank, world, store, outdir, fixtures = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    init_world("cpu", store, rank=rank, world_size=world)
    out: dict = {}
    try:
        for shape, cases in MESHES[world]:
            serving(make_debug_mesh(*shape), shape, cases, rank, fixtures, out)
        if world == 2:
            phase14_cell(make_debug_mesh(1, 2), rank, out)
        if world == 4:
            expert_parallel(make_debug_mesh(2, 2), fixtures, out)
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
