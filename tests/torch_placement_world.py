"""One rank of a gloo world that runs the port's placed engines on the CPU
and writes what they gave, for ``tests/test_torch_placement.py``.

    python tests/torch_placement_world.py RANK WORLD STORE OUT FIXTURES

``STORE`` is the ``FileStore`` path the ranks meet at, ``OUT`` a directory
for the results (rank 0 writes ``world<WORLD>.pkl``, every rank its own
``world<WORLD>_rank<RANK>.pkl`` of local shapes), ``FIXTURES`` the
directory holding ``bank.npz`` (the 8-chain reduced qwen3-4b bank the JAX
package drew, in the port's layout).  A world of 2 ranks places the chains
over ``data`` 2; a world of 4 over the JAX package's debug mesh (``data``
2 x ``model`` 2) for the cluster and over ``data`` 4 x ``model`` 1 for
serving, and last over ``data`` 2 on ranks 0 and 1 alone (a mesh smaller
than the world).  Rank 0 runs every unplaced engine beside the placed one,
so the bitwise comparisons stay inside one process.  This process imports no JAX.
"""

import os
import pickle
import sys
import traceback
import types
from dataclasses import replace

sys.modules["jax"] = None  # the port must not reach for JAX

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import samplers  # noqa: E402
from repro_torch.checkpoint import restore_checkpoint  # noqa: E402
from repro_torch.cluster import (  # noqa: E402
    ClusterEngine,
    DecodeEngine,
    PagedDecodeEngine,
    Request,
    ServeEngine,
    ensemble_async,
    w2_recorder,
)
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core import PolyRegression, Quadratic, WorkerModel  # noqa: E402
from repro_torch.data import Prefetcher  # noqa: E402
from repro_torch.kernels import ops, rng  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    batch_axes_for,
    fsdp_axes_for,
    init_world,
    make_debug_mesh,
    make_production_mesh,
)
from repro_torch.models import regression_predict, transformer_next_token_predict  # noqa: E402
from repro_torch.models.transformer import Model, init_params  # noqa: E402
from repro_torch.utils import (  # noqa: E402
    bucket_size,
    chain_block,
    gather_rows,
    is_placed,
    local,
    place_chains,
    tree_leaves,
)

C, STEPS, D = 8, 20, 4
LOCAL: dict = {}  # what this rank's placed tensors held: name -> leading sizes
ROWS: dict = {}  # predict fn -> whether a block of the bank gives its rows bit for bit


def rows_bitwise(name: str, predict, bank, queries, block) -> None:
    """Record whether ``predict`` on this rank's block of ``bank`` gives
    its rows of ``predict`` on the whole bank bit for bit."""
    with torch.no_grad():
        whole, part = predict(bank, queries), predict(bank[block], queries)
    ROWS[name] = bool(torch.equal(whole[block], part))


def host(x):
    """Numpy of a tensor, a placed one gathered; a tree leaf by leaf."""
    if isinstance(x, dict):
        return {k: host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return [host(v) for v in x]
    if torch.is_tensor(x):
        x = x.full_tensor() if is_placed(x) else x
        return x.detach().cpu().numpy()
    return np.asarray(x)


def note_local(name: str, tree, dim: int = 0) -> None:
    """Record the leading sizes of this rank's local tensors of ``tree``."""
    LOCAL[name] = sorted({int(t.shape[dim]) for t in tree_leaves(local(tree))
                          if torch.is_tensor(t) and t.dim() > dim})


# -- the cluster -------------------------------------------------------------------------
def quad_sampler(mode="consistent", fused=False, tau=8, d=D):
    quad = Quadratic.make(rng.PRNGKey(0), d=d, m=1.0, L=3.0, device="cpu")
    return samplers.sgld(mode, lambda p, b: quad.grad(p, b), gamma=0.01, sigma=0.5,
                         tau=tau, fused=fused, noise="jax")


def both(sampler, mesh, rank, run_kw, init_kw=None, **ekw):
    """Run the placed engine (every rank) and the unplaced one (rank 0):
    -> (placed state, unplaced state or None, placed engine, unplaced
    engine or None)."""
    init_kw = dict(init_kw or {"params": torch.zeros(D), "key": rng.PRNGKey(42),
                               "jitter": 1.0})
    placed = ClusterEngine(sampler, num_chains=C, mesh=mesh, **ekw)
    st = placed.init(**init_kw)
    st, _ = placed.run(st, **run_kw)
    ref = plain = None
    if rank == 0:
        plain = ClusterEngine(sampler, num_chains=C, **ekw)
        ref, _ = plain.run(plain.init(**init_kw), **run_kw)
    return st, ref, placed, plain


def cluster_state(st, ref, mesh):
    """Host arrays of a placed state (gathered: the keys too) and of the
    unplaced one."""
    s, r = getattr(st, "state", st), getattr(ref, "state", ref)
    keys = gather_rows(torch.tensor(s.key, dtype=torch.int64), mesh, "data")
    out = {"params": host(s.params), "step": s.step, "key": keys.numpy()}
    if ref is not None:
        out.update(ref_params=host(r.params), ref_key=np.asarray(r.key, np.int64),
                   ref_step=r.step)
        if hasattr(ref, "health"):
            out["ref_health"] = np.asarray(ref.health)
    if hasattr(st, "health"):
        out["health"] = np.asarray(st.health)
    return out


def cluster_scenarios(mesh, rank, out, tmp):
    scheds = ensemble_async(WorkerModel(num_workers=4, seed=1), STEPS, C, seed=0)
    hook, ref_hook = (w2_recorder(np.random.default_rng(4).standard_normal((64, D))
                                  .astype(np.float32), every=10) for _ in range(2))
    for name, mode, fused in (("sgld", "consistent", False),
                              ("fused", "inconsistent", True)):
        s = quad_sampler(mode, fused)
        st, ref, eng, _ = both(s, mesh, rank, dict(steps=STEPS, schedule=scheds),
                            chunk_size=10, hooks=[hook] if name == "sgld" else ())
        note_local(f"cluster_{name}", (st.params, st.inner))
        LOCAL[f"cluster_{name}_keys"] = [len(st.key)]
        out[f"cluster_{name}"] = cluster_state(st, ref, mesh)
        if name == "sgld":
            out["w2_placed"] = [r["w2"] for r in hook.record]
            if rank == 0:
                plain = ClusterEngine(s, num_chains=C, chunk_size=10, hooks=[ref_hook])
                plain.run(plain.init(torch.zeros(D), rng.PRNGKey(42), jitter=1.0),
                          steps=STEPS, schedule=scheds)
                out["w2_unplaced"] = [r["w2"] for r in ref_hook.record]
            # save_ensemble: the origin rank writes the file an unplaced run writes
            bank = os.path.join(tmp, "bank_placed.npz")
            eng.save_ensemble(st, bank)
            if rank == 0:
                plain_bank = os.path.join(tmp, "bank_plain.npz")
                ClusterEngine(s, num_chains=C).save_ensemble(ref, plain_bank)
                out["save_ensemble"] = ({k: v for k, v in np.load(bank).items()},
                                        {k: v for k, v in np.load(plain_bank).items()})
            # a bank-form predict fn served straight from the placed state
            def predict(w, q):
                return w @ q.T  # (C, 4) x (Q, 4) -> (C, Q)

            q = np.random.default_rng(9).standard_normal((5, D)).astype(np.float32)
            if rank == 0:
                rows_bitwise("quad", predict, ref.params, torch.from_numpy(q),
                             chain_block(mesh, "data", C))
            srv = ServeEngine.from_cluster(st, predict_fn=predict, device="cpu")
            out["from_cluster"] = [np.asarray(v) for v in srv(q)]
            if rank == 0:
                plain_srv = ServeEngine.from_cluster(ref, predict_fn=predict, device="cpu")
                out["from_cluster_ref"] = [np.asarray(v) for v in plain_srv(q)]

    # the masked path (inverse-speed batches), as the JAX package's sharded test
    d, b0 = 3, 4
    quad = Quadratic.make(rng.PRNGKey(0), d=d, m=1.0, L=3.0, device="cpu")
    wm = WorkerModel(num_workers=4, heterogeneity=0.6, seed=1)
    msched = ensemble_async(wm, STEPS, C, seed=0, batch_policy="inverse-speed",
                            base_batch=b0)
    tau = max(s.max_delay for s in msched)
    ms = samplers.sgld("consistent", lambda p, e: quad.grad(p, None) + 0.3 * e,
                       gamma=0.01, sigma=0.5, tau=max(tau, 1), base_batch=b0,
                       noise="jax")
    data = torch.from_numpy(np.random.default_rng(2).standard_normal((512, d))
                            .astype(np.float32))
    st, ref, eng, plain = both(ms, mesh, rank, dict(steps=STEPS, schedule=msched,
                                                    data=data),
                               init_kw={"params": torch.zeros(d), "key": rng.PRNGKey(42)},
                               chunk_size=10, batch_policy="inverse-speed")
    out["cluster_masked"] = cluster_state(st, ref, mesh)
    out["masked_traces"] = (eng.num_traces, plain.num_traces if plain else None)

    # health_check: poisons put every chain of the first block (and chain 6)
    # in quarantine, so most donors lie on another rank
    poison = np.zeros((STEPS, C), bool)
    poison[3, :C // 2] = True
    poison[12, 6] = True
    st, ref, _, _ = both(quad_sampler("inconsistent", True), mesh, rank,
                      dict(steps=STEPS, schedule=scheds, poison=poison),
                      chunk_size=5, health_check=True)
    out["cluster_health"] = cluster_state(st, ref, mesh)
    out["health_poison"] = poison

    # batch_fn: one key a (commit, chain), the reference's order; a rank
    # makes only its block's batches
    quad = Quadratic.make(rng.PRNGKey(0), d=D, m=1.0, L=3.0, device="cpu")
    bs = samplers.sgld("consistent", lambda p, b: quad.grad(p, None) + 0.3 * b,
                       gamma=0.01, sigma=0.5, tau=8, noise="jax")
    st, ref, _, _ = both(bs, mesh, rank, dict(steps=STEPS, schedule=scheds, key=7),
                         chunk_size=10, batch_fn=lambda k: rng.jax_normal(k, (D,)))
    out["cluster_batch"] = cluster_state(st, ref, mesh)

    # a run checkpoint and resume, stitched; the file against an unplaced run's
    s = quad_sampler("inconsistent", True)

    def engine(m):
        return ClusterEngine(s, num_chains=C, chunk_size=5, health_check=True, mesh=m)

    def start(m):
        return engine(m).init(torch.zeros(D), rng.PRNGKey(6))

    ck = os.path.join(tmp, "run_placed.npz")
    full, _ = engine(mesh).run(start(mesh), steps=STEPS, schedule=scheds, poison=poison)
    engine(mesh).run(start(mesh), steps=10, schedule=scheds, poison=poison[:10],
                     checkpoint_path=ck)
    at10 = {k: v for k, v in np.load(ck).items()} if rank == 0 else None
    resumed, _ = engine(mesh).resume(ck, start(mesh), steps=STEPS, schedule=scheds,
                                     poison=poison)
    out["resume"] = {"full": cluster_state(full, None, mesh),
                     "resumed": cluster_state(resumed, None, mesh)}
    LOCAL["resume_keys"] = [len(resumed.state.key)]
    note_local("resume", (resumed.state.params, resumed.state.inner))
    if rank == 0:
        ck_plain = os.path.join(tmp, "run_plain.npz")
        engine(None).run(start(None), steps=10, schedule=scheds, poison=poison[:10],
                         checkpoint_path=ck_plain)
        out["run_checkpoint"] = (at10, {k: v for k, v in np.load(ck_plain).items()})


# -- serving -----------------------------------------------------------------------------
def lm_bank(fixtures):
    cfg = replace(get_reduced("qwen3-4b"), dtype="float32")
    like = init_params(cfg, None, device="meta", num_chains=C)
    bank = restore_checkpoint(os.path.join(fixtures, "bank.npz"), like, device="cpu")
    return cfg, bank


def serving_scenarios(mesh, rank, out, fixtures):
    cfg, bank = lm_bank(fixtures)
    block = chain_block(mesh, "data", C)
    model = Model(cfg, device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 5)).astype(np.int32)
    # does a C/n-chain bank give its rows of the C-chain forward bit for bit?
    with torch.no_grad():
        whole, _ = model.prefill(bank, {"tokens": toks})
        part, _ = model.prefill({k: v for k, v in _rows(bank, block).items()},
                                {"tokens": toks})
    ROWS["lm"] = bool(torch.equal(whole[block], part))

    placed = DecodeEngine(cfg, bank, max_seq=32, return_logits=True, device="cpu",
                          mesh=mesh)
    note_local("decode_bank", placed.params)
    res = placed.generate(toks, 6)
    sampled = placed.generate(toks[:2], 4, key=7)
    cache = next(iter(placed._cache.values()))["attn"]
    note_local("decode_cache", [cache["k"], cache["v"]], dim=1)
    out["decode"] = {"tokens": res.tokens, "logits": res.logits, "sampled": sampled.tokens}
    restored = DecodeEngine.from_checkpoint(
        os.path.join(fixtures, "bank.npz"), like=init_params(cfg, None, device="meta"),
        model=cfg, max_seq=32, return_logits=True, device="cpu", mesh=mesh)
    note_local("decode_restored", restored.params)
    r2 = restored.generate(toks, 6)
    out["decode_restored"] = {"tokens": r2.tokens, "logits": r2.logits}
    if rank == 0:
        plain = DecodeEngine(cfg, bank, max_seq=32, return_logits=True, device="cpu")
        ref = plain.generate(toks, 6)
        out["decode_ref"] = {"tokens": ref.tokens, "logits": ref.logits,
                             "sampled": plain.generate(toks[:2], 4, key=7).tokens}

    eng, got = paged(cfg, bank, mesh)
    note_local("paged_pool", eng._pages, dim=1)
    out["paged"] = got
    if rank == 0:
        out["paged_ref"] = paged(cfg, bank, None)[1]

    # next-token serving on the LM bank, and the decoder it hands out
    lm_toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (3, 8)).astype(np.int32)
    predict = transformer_next_token_predict(model)
    srv = ServeEngine(predict_fn=predict, params=bank, quantiles=(0.1, 0.9),
                      device="cpu", mesh=mesh)
    out["lm_serve"] = [np.asarray(v) for v in srv({"tokens": lm_toks})]
    dec = srv.decoder(cfg, max_seq=32)
    out["decoder"] = dec.generate(toks[:2], 4).tokens
    out["decoder_placed"] = dec.mesh is mesh and dec.params is srv.params
    if rank == 0:
        plain = ServeEngine(predict_fn=predict, params=bank, quantiles=(0.1, 0.9),
                            device="cpu")
        out["lm_serve_ref"] = [np.asarray(v) for v in plain({"tokens": lm_toks})]
        out["decoder_ref"] = DecodeEngine(cfg, bank, max_seq=32, device="cpu").generate(
            toks[:2], 4).tokens

    # the regression bank of the JAX package's sharded serving test
    reg = PolyRegression.make(rng.PRNGKey(0), device="cpu")
    rbank = torch.from_numpy(np.random.default_rng(1).standard_normal((C, 5))
                             .astype(np.float32))
    rsrv = ServeEngine(predict_fn=regression_predict(reg), params=rbank, device="cpu",
                       mesh=mesh)
    note_local("serve_bank", rsrv.params)
    qs = [np.random.default_rng(10 + i).uniform(-1, 1, n).astype(np.float32)
          for i, n in enumerate((5, 3, 16, 8))]
    for i, z in enumerate(qs):  # the batches as the engine pads them
        padded = np.concatenate([z, np.repeat(z[-1:], bucket_size(len(z)) - len(z))])
        rows_bitwise(f"reg{i}", regression_predict(reg), rbank, torch.from_numpy(padded),
                     block)
    ROWS["reg"] = all([ROWS.pop(f"reg{i}") for i in range(len(qs))])
    out["serve"] = [[np.asarray(v) for v in rsrv(z)] for z in qs]
    out["serve_traces"] = rsrv.num_traces
    if rank == 0:
        plain = ServeEngine(predict_fn=regression_predict(reg), params=rbank, device="cpu")
        out["serve_ref"] = [[np.asarray(v) for v in plain(z)] for z in qs]


def paged(cfg, bank, m):
    """Three requests through a paged engine over ``m`` (None: unplaced);
    one carries a deadline it never meets, which the placed engine judges
    on the mesh's origin rank -> (engine, [(tokens, logits)] by request)."""
    gen = np.random.default_rng(0)
    reqs = [(gen.integers(0, cfg.vocab_size, (t,)).astype(np.int32), n)
            for t, n in [(5, 6), (3, 4), (7, 5)]]
    eng = PagedDecodeEngine(cfg, bank, num_slots=2, page_size=8, max_seq=32,
                            decode_chunk=4, return_logits=True, device="cpu", mesh=m)
    ids = [eng.submit(Request(tokens=t, max_new_tokens=n,
                              deadline_ms=1e9 if i == 1 else None,
                              key=None if i != 2 else 11))
           for i, (t, n) in enumerate(reqs)]
    comps = {c.request_id: c for c in eng.drain()}
    return eng, [(comps[i].tokens, comps[i].logits) for i in ids]


def submesh_scenario(rank, out, tmp, fixtures):
    """A mesh over ranks 0 and 1 of the world alone: a run checkpoint and
    its resume, and a paged request with a deadline, whose collectives
    (the checkpoint's barrier, the deadline's broadcast) stay on the mesh's
    ranks while the others pass on."""
    mesh = make_debug_mesh(data=2, model=1)  # every rank of the world builds it
    if mesh.get_coordinate() is None:
        return
    s = quad_sampler("inconsistent", True)

    def engine(m):
        return ClusterEngine(s, num_chains=C, chunk_size=5, health_check=True, mesh=m)

    def start(m):
        return engine(m).init(torch.zeros(D), rng.PRNGKey(6))

    ck = os.path.join(tmp, "run_submesh.npz")
    engine(mesh).run(start(mesh), steps=5, checkpoint_path=ck)
    resumed, _ = engine(mesh).resume(ck, start(mesh), steps=10)
    cfg, bank = lm_bank(fixtures)
    got = {"resumed": cluster_state(resumed, None, mesh),
           "paged": paged(cfg, bank, mesh)[1]}
    if rank == 0:
        got["full_ref"] = host(engine(None).run(start(None), steps=10)[0].state.params)
        got["paged_ref"] = paged(cfg, bank, None)[1]
    out["submesh"] = got


def _rows(tree, block):
    if isinstance(tree, dict):
        return {k: _rows(v, block) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rows(v, block) for v in tree]
    return tree[block]


# -- degraded serving of a placed bank ---------------------------------------------------
def degraded_scenario(mesh, rank, out, fixtures):
    """A placed 4-chain bank with chain 1 (rank 0's) and chain 2 (rank 1's)
    quarantined: ``from_cluster`` gathers the survivors, places them again
    over ``data`` and serves; rank 0 also serves the whole bank degraded,
    unplaced.  Then one chain quarantined: 3 survivors over 2 ranks are
    refused."""
    from repro_torch.obs.metrics import registry

    cfg, bank = lm_bank(fixtures)
    four = _rows(bank, slice(0, 4))
    placed = place_chains(_rows(four, chain_block(mesh, "data", 4)), mesh, "data")
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size, (3, 5)).astype(np.int32)
    kw = dict(max_seq=32, return_logits=True, device="cpu")
    two = np.array([True, False, False, True])
    eng = DecodeEngine.from_cluster(types.SimpleNamespace(params=placed, health=two),
                                    cfg, **kw)
    res = eng.generate(toks, 6)
    out["degraded"] = {"tokens": res.tokens, "logits": res.logits,
                       "num_chains": eng.num_chains, "mesh": eng.mesh is mesh,
                       "local": sorted({int(t.shape[0]) for t in tree_leaves(local(eng.params))}),
                       "unhealthy": registry().gauge("chains.unhealthy").value}
    if rank == 0:
        plain = DecodeEngine.from_cluster(types.SimpleNamespace(params=four, health=two),
                                          cfg, **kw).generate(toks, 6)
        out["degraded_ref"] = {"tokens": plain.tokens, "logits": plain.logits}
    one = np.array([True, False, True, True])
    try:
        DecodeEngine.from_cluster(types.SimpleNamespace(params=placed, health=one), cfg, **kw)
        out["degraded_refusal"] = None
    except ValueError as e:
        out["degraded_refusal"] = str(e)


# -- the prefetcher ----------------------------------------------------------------------
def prefetch_scenario(mesh, out):
    def batch_fn(key):
        s = rng.seed_int(key) % 1000
        return {"x": np.arange(8 * 3, dtype=np.float32).reshape(8, 3) + s,
                "n": np.float32(s)}

    got = {}
    for axes in (("data",), ()):
        pf = Prefetcher(batch_fn, rng.PRNGKey(3), device="cpu", mesh=mesh, batch_axes=axes)
        rows = [next(pf) for _ in range(3)]
        pf.close()
        note_local(f"prefetch_{'-'.join(axes) or 'replicated'}", rows)
        got[axes] = [{k: host(v) for k, v in b.items()} for b in rows]
        got[(axes, "local")] = [b["x"].to_local().numpy() for b in rows]
        got[(axes, "placements")] = [str(b["x"].placements) for b in rows]
    pf = Prefetcher(batch_fn, rng.PRNGKey(3), device="cpu")
    got["unplaced"] = [{k: v.numpy() for k, v in next(pf).items()} for _ in range(3)]
    pf.close()
    got["batch_axes_for"] = batch_axes_for(mesh, 8), batch_axes_for(mesh, 3)
    got["fsdp_axes_for"] = fsdp_axes_for(mesh)
    out["prefetch"] = got


# -- refusals ----------------------------------------------------------------------------
def refusals(mesh, out):
    def caught(fn):
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — the test reads the type and text
            return type(e).__name__, str(e)
        return None

    cfg, s = get_reduced("qwen3-4b"), quad_sampler()
    tp_mesh = make_debug_mesh(data=1, model=2)
    moe_cfg = replace(get_reduced("phi3.5-moe-42b-a6.6b"), num_experts=3)
    g2_cfg = replace(cfg, num_heads=6, num_kv_heads=3)  # 3 query heads a rank, G 2
    hist = place_chains(torch.zeros(C // mesh.shape[0], 3, 4), mesh, "data")
    delays = place_chains(torch.zeros(C // mesh.shape[0], 4, dtype=torch.int32), mesh, "data")
    bank = init_params(cfg, 0, device="cpu", num_chains=C)
    out["refusals"] = {
        "dtensor_op": caught(lambda: ops.delay_gather(hist, delays, [0] * C)),
        "dtensor_update": caught(lambda: ops.fused_langevin_update(
            {"w": hist}, {"w": hist}, [(0, 1)] * C, [np.float32(0.1)] * C,
            [np.float32(0.1)] * C)),
        # the model axis' refusals, on the world's (data 1, model 2) mesh:
        # experts the axis does not divide, a query block straddling a group
        "experts_not_dividing": caught(lambda: DecodeEngine(
            moe_cfg, init_params(moe_cfg, 0, device="cpu", num_chains=2), device="cpu",
            mesh=tp_mesh, shard_params=True)),
        "straddling_group": caught(lambda: DecodeEngine(
            g2_cfg, init_params(g2_cfg, 0, device="cpu", num_chains=2), device="cpu",
            mesh=tp_mesh, shard_params=True)),
        "not_dividing": caught(lambda: ClusterEngine(s, num_chains=3, mesh=mesh)),
        "no_chain_axis": caught(lambda: ClusterEngine(s, num_chains=C, mesh=mesh,
                                                      chain_axis="pod")),
        "not_a_mesh": caught(lambda: ClusterEngine(s, num_chains=C, mesh=object())),
        "bank_not_dividing": caught(lambda: ServeEngine(
            predict_fn=lambda w, q: w, params=torch.zeros(3, 5), device="cpu", mesh=mesh)),
        "mesh_too_big": caught(lambda: make_debug_mesh(data=4, model=4)),
        "production_mesh": caught(make_production_mesh),
    }


def main() -> int:
    rank, world, store, outdir, fixtures = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    init_world("cpu", store, rank=rank, world_size=world)
    out: dict = {}
    tmp = os.path.join(outdir, f"scratch{world}")  # the checkpoints every rank reads
    os.makedirs(tmp, exist_ok=True)
    try:
        if world == 2:
            mesh = make_debug_mesh(data=2, model=1)
            cluster_scenarios(mesh, rank, out, tmp)
            serving_scenarios(mesh, rank, out, fixtures)
            prefetch_scenario(mesh, out)
            degraded_scenario(mesh, rank, out, fixtures)
            refusals(mesh, out)
        else:
            cluster_scenarios(make_debug_mesh(data=2, model=2), rank, out, tmp)
            serving_scenarios(make_debug_mesh(data=4, model=1), rank, out, fixtures)
            prefetch_scenario(make_debug_mesh(data=2, model=2), out)
            submesh_scenario(rank, out, tmp, fixtures)
    except BaseException:  # noqa: BLE001 — reported to the test, then re-raised
        out["error"] = traceback.format_exc()
        _dump(outdir, world, rank, out)
        raise
    _dump(outdir, world, rank, out)
    torch.distributed.destroy_process_group()
    return 0


def _dump(outdir, world, rank, out):
    if rank == 0:
        with open(os.path.join(outdir, f"world{world}.pkl"), "wb") as f:
            pickle.dump(out, f)
    with open(os.path.join(outdir, f"world{world}_rank{rank}.pkl"), "wb") as f:
        pickle.dump({"local": LOCAL, "error": out.get("error"),
                     "rows_bitwise": ROWS}, f)


if __name__ == "__main__":
    sys.exit(main())
