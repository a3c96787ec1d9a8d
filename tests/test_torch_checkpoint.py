"""repro_torch.checkpoint against repro.checkpoint, on the CPU: the file
format is the JAX package's, so a file written by either package restores
in the other with the same dtypes (bfloat16 included) and equal arrays,
and a truncated or bit-flipped file raises ``CorruptCheckpointError``
naming the damage in both.  Then the training-side users of the format:
``checkpoint_hook`` and its final flush, ``train_loop`` against the JAX
package's history at sigma 0 (losses within rtol 1e-5: float32 rounding
apart), ``launch.train --save`` read by the JAX package's
``restore_ensemble``, and ``save_ensemble`` served back through
``from_checkpoint`` (the JAX engine's greedy tokens, log-probs within
1e-4, as ``tests/test_torch_engines.py`` holds them)."""

import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path
from typing import NamedTuple

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import CorruptCheckpointError as JCorruptCheckpointError
from repro.checkpoint import restore_checkpoint as jrestore
from repro.checkpoint import restore_ensemble as jrestore_ensemble
from repro.checkpoint import save_checkpoint as jsave
from repro.cluster import DecodeEngine as JDecodeEngine
from repro.configs import get_reduced as jax_reduced
from repro.core.sgld import SGLDConfig as JSGLDConfig
from repro.models.transformer import Model as JModel
from repro.models.transformer import init_params as jax_init
from repro.train.loop import train_loop as jtrain_loop
from repro_torch import samplers
from repro_torch.checkpoint import (
    CorruptCheckpointError,
    checkpoint_step,
    leaf_paths,
    restore_checkpoint,
    restore_ensemble,
    save_checkpoint,
)
from repro_torch.cluster import ClusterEngine, DecodeEngine, PagedDecodeEngine
from repro_torch.configs import get_reduced
from repro_torch.core import Quadratic
from repro_torch.core.delay import init_ring
from repro_torch.core.sgld import SGLDConfig
from repro_torch.kernels import rng
from repro_torch.models.transformer import Model, init_params
from repro_torch.samplers.transform import one_chain
from repro_torch.train.engine import Engine, checkpoint_hook
from repro_torch.train.loop import train_loop
from repro_torch.utils import tree_leaves, tree_map
from repro_torch.weights import from_jax_params
from torch_cases import one_cpu_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


class Pair(NamedTuple):
    a: torch.Tensor
    b: dict


def _trees():
    g = torch.Generator().manual_seed(0)
    f32 = torch.randn(3, 5, generator=g)
    bf16 = torch.randn(4, 7, generator=g).to(torch.bfloat16)
    bf16[0, :3] = torch.tensor([float("nan"), -0.0, float("inf")])
    ints = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    ring = one_chain(init_ring({"w": f32, "v": bf16}, 2))
    return {
        "f32": f32,
        "bf16": bf16,
        "int": {"i32": ints, "i64": torch.arange(3), "flag": torch.tensor([True, False])},
        "nested": {"z": {"y": [f32, (ints, bf16)]}, "a": f32[:1]},
        "namedtuple": Pair(f32, {"k": bf16}),
        "ring": ring,
    }


def _bits(t):
    return t.contiguous().view(torch.uint8) if t.dtype != torch.bool else t


@pytest.mark.parametrize("name", ["f32", "bf16", "int", "nested", "namedtuple", "ring"])
def test_round_trip(tmp_path, name):
    tree = _trees()[name]
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, tree, step=7)
    got = restore_checkpoint(path, tree)
    assert checkpoint_step(path) == 7
    assert type(got) is type(tree)
    want, back = leaf_paths(tree), leaf_paths(got)
    assert [p for p, _ in want] == [p for p, _ in back]
    for (_, w), (_, b) in zip(want, back):
        assert b.dtype == w.dtype and torch.equal(_bits(b), _bits(w))
    if name == "ring":
        assert [p for p, _ in want] == [".history##v", ".history##w", ".head"]
        assert got.depth == tree.depth
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path))  # renamed


def test_paths_are_jax_paths(tmp_path):
    """The flat paths of a nested tree — dict keys sorted, indices, named
    tuple fields — are the JAX package's, member for member."""
    tree = _trees()["nested"]
    jtree = jax.tree_util.tree_map(lambda t: np.asarray(t.float()), tree)
    jsave(str(tmp_path / "j.npz"), jtree)
    save_checkpoint(str(tmp_path / "t.npz"), tree)
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t:
        assert sorted(j.files) == sorted(set(t.files) - {"__bf16__"})


def _jax_tree():
    r = np.random.default_rng(1)
    return {"w": jnp.asarray(r.standard_normal((3, 4)), jnp.float32),
            "h": jnp.asarray(r.standard_normal((2, 5)), jnp.bfloat16),
            "n": {"i": jnp.arange(6, dtype=jnp.int32), "b": jnp.array([True, False])}}


def test_jax_file_restores_in_the_port(tmp_path):
    jt = _jax_tree()
    path = str(tmp_path / "j.npz")
    jsave(path, jt, step=3)
    like = tree_map(lambda a: torch.zeros(1), jax.tree_util.tree_map(np.asarray, jt))
    got = restore_checkpoint(path, like)
    assert checkpoint_step(path) == 3
    assert got["h"].dtype == torch.bfloat16 and got["n"]["i"].dtype == torch.int32
    for p, t in leaf_paths(got):
        want = np.asarray(dict(leaf_paths(jax.tree_util.tree_map(np.asarray, jt)))[p])
        if t.dtype == torch.bfloat16:
            assert t.view(torch.int16).numpy().tobytes() == want.tobytes()
        else:
            assert np.array_equal(t.numpy(), want)


def test_port_file_restores_in_jax(tmp_path):
    tree = {k: v for k, v in _trees().items() if k in ("f32", "bf16", "int")}
    path = str(tmp_path / "t.npz")
    save_checkpoint(path, tree, step=5)
    like = jax.tree_util.tree_map(lambda t: np.zeros(1), tree)
    got = jrestore(path, like)
    for (p, t), w in zip(leaf_paths(tree), jax.tree_util.tree_leaves(got)):
        w = np.asarray(w)
        if t.dtype == torch.bfloat16:
            assert w.dtype == ml_dtypes.bfloat16
            assert w.tobytes() == t.view(torch.int16).numpy().tobytes()
        else:
            assert np.array_equal(w, t.numpy()), p


def test_restore_ensemble_layouts_and_refusals(tmp_path):
    like = {"w": torch.zeros(3, 4), "b": torch.zeros(4)}
    single = {"w": torch.randn(3, 4), "b": torch.randn(4)}
    bank = {"w": torch.randn(5, 3, 4), "b": torch.randn(5, 4)}
    ps, pb = str(tmp_path / "s.npz"), str(tmp_path / "b.npz")
    save_checkpoint(ps, single)
    save_checkpoint(pb, bank)
    got = restore_ensemble(ps, like, num_chains=4)
    assert got["w"].shape == (4, 3, 4) and torch.equal(got["w"][3], single["w"])
    got = restore_ensemble(pb, like)
    assert torch.equal(got["w"], bank["w"]) and torch.equal(got["b"], bank["b"])
    with pytest.raises(ValueError, match="num_chains"):
        restore_ensemble(ps, like)
    with pytest.raises(ValueError, match="holds 5 chains"):
        restore_ensemble(pb, like, num_chains=4)
    mixed = str(tmp_path / "m.npz")
    save_checkpoint(mixed, {"w": bank["w"], "b": single["b"]})
    with pytest.raises(ValueError, match="neither"):
        restore_ensemble(mixed, like)
    # the JAX package reads the same layouts from the port's files
    jgot = jrestore_ensemble(ps, {"w": np.zeros((3, 4)), "b": np.zeros(4)}, num_chains=2)
    assert np.asarray(jgot["w"]).shape == (2, 3, 4)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_truncated_and_flipped_files_raise_in_both_packages(tmp_path, writer):
    tree = {"w": np.arange(4096, dtype=np.float32), "v": np.ones(64, np.float32)}
    path = tmp_path / "ck.npz"
    if writer == "jax":
        jsave(str(path), tree)
    else:
        save_checkpoint(str(path), {k: torch.from_numpy(v) for k, v in tree.items()})
    blob = path.read_bytes()
    (tmp_path / "trunc.npz").write_bytes(blob[:len(blob) // 2])
    flipped = bytearray(blob)
    at = blob.index(np.arange(8, 16, dtype=np.float32).tobytes())  # inside leaf "w"
    flipped[at] ^= 0x01
    (tmp_path / "flip.npz").write_bytes(bytes(flipped))
    like_t = {k: torch.zeros(1) for k in tree}
    like_j = {k: np.zeros(1) for k in tree}
    for bad in ("trunc.npz", "flip.npz"):
        with pytest.raises(CorruptCheckpointError) as e:
            restore_checkpoint(str(tmp_path / bad), like_t)
        with pytest.raises(JCorruptCheckpointError):
            jrestore(str(tmp_path / bad), like_j)
        if bad == "flip.npz":  # the damaged leaf is named (zip's CRC or ours)
            assert "'w" in str(e.value)


def test_checkpoint_hook_flushes_the_final_state(tmp_path):
    """every=5 over 10 commits in chunks of 3: the cadence saves at 6 (not
    at 9 or 10, fewer than 5 commits on), and the flush saves commit 10 —
    the final parameters."""
    tq = Quadratic.make(rng.PRNGKey(0), d=4, m=1.0, L=3.0, device="cpu")
    s = samplers.sgld("sync", lambda p, b: tq.grad(p, b), gamma=0.05, sigma=0.1)
    path = str(tmp_path / "hook.npz")
    hook = checkpoint_hook(path, every=5)
    seen = []
    eng = Engine(s, chunk_size=3, hooks=[hook, lambda n, st, aux: seen.append(
        (n, checkpoint_step(path) if os.path.exists(path) else None))])
    state, _ = eng.run(s.init(torch.zeros(4), rng.PRNGKey(1)), steps=10,
                       batches=torch.zeros(10, 1))
    assert seen == [(3, None), (6, 6), (9, 6), (10, 6)]
    assert checkpoint_step(path) == 10
    assert torch.equal(restore_checkpoint(path, torch.zeros(4)), state.params)


def test_train_loop_matches_jax_history_at_sigma_zero():
    jcfg = replace(jax_reduced("qwen3-4b"), dtype="float32")
    tcfg = replace(get_reduced("qwen3-4b"), dtype="float32")
    jp = jax_init(jax.random.PRNGKey(0), jcfg)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 17)).astype(np.int32)
    delays = np.array([0, 1, 2, 1, 0, 2, 2, 1], np.int32)
    kw = dict(mode="consistent", gamma=1e-3, sigma=0.0, tau=2)
    _, jhist = jtrain_loop(JModel(jcfg, mesh=None), jp, JSGLDConfig(**kw),
                           lambda k: {"tokens": jnp.asarray(tokens)}, 8,
                           jax.random.PRNGKey(3), delays=delays, log_every=3,
                           log_fn=lambda _: None)
    state, hist = train_loop(Model(tcfg, device="cpu"), tp, SGLDConfig(**kw),
                             lambda g: {"tokens": torch.from_numpy(tokens)}, 8,
                             rng.PRNGKey(3), delays=delays, log_every=3,
                             log_fn=lambda _: None)
    assert [k for k, _ in hist] == [k for k, _ in jhist] == [0, 3, 6, 7]
    np.testing.assert_allclose([v for _, v in hist], [v for _, v in jhist], rtol=1e-5)
    assert state.step == 8


def test_launcher_save_is_read_by_jax_restore_ensemble(tmp_path):
    # one ATen thread in the launcher: with its default of one a core, next
    # to the suite's other worker processes, six such runs took 909 s
    # together where one takes 7 s (threads spinning against each other)
    path = str(tmp_path / "launch.npz")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen3-4b",
         "--reduced", "--device", "cpu", "--steps", "4", "--mode", "inconsistent",
         "--fused", "--tau", "2", "--chunk", "2", "--save", path],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "saved" in proc.stdout and checkpoint_step(path) == 4
    jcfg = jax_reduced("qwen3-4b")
    like = jax_init(jax.random.PRNGKey(0), jcfg)  # no chain axis
    bank = jrestore_ensemble(path, like, num_chains=4)
    for a, b in zip(jax.tree_util.tree_leaves(bank), jax.tree_util.tree_leaves(like)):
        assert a.shape == (4, *b.shape) and a.dtype == b.dtype
    ours = restore_ensemble(path, init_params(get_reduced("qwen3-4b"), None, device="meta"),
                            num_chains=4, device="cpu")
    for a, b in zip(tree_leaves(ours), jax.tree_util.tree_leaves(bank)):
        raw = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        assert raw.numpy().tobytes() == np.asarray(b).tobytes()


def test_save_ensemble_serves_through_from_checkpoint(tmp_path):
    """A 3-chain ensemble of the reduced model (leaves ``(3, 1, ...)``) is
    saved in the JAX layout and served by both packages' engines: the same
    greedy tokens.  ``from_checkpoint`` takes ``(path, like, model)`` and
    the legacy ``(path, model, like)``; a single-model file is broadcast."""
    jcfg = replace(jax_reduced("qwen3-4b"), dtype="float32")
    tcfg = replace(get_reduced("qwen3-4b"), dtype="float32")
    jp = jax_init(jax.random.PRNGKey(5), jcfg)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    tq = Quadratic.make(rng.PRNGKey(0), d=4, m=1.0, L=3.0, device="cpu")
    s = samplers.sgld("sync", lambda p, b: tq.grad(p, b), gamma=0.0, sigma=0.0)
    e = ClusterEngine(s, num_chains=3)
    state = e.init(tp, rng.PRNGKey(0), jitter=0.0)
    state.params["final_norm"][1].mul_(1.5)  # the chains differ
    assert state.params["embed"]["w"].shape[:2] == (3, 1)
    path = str(tmp_path / "bank.npz")
    e.save_ensemble(state, path)
    assert checkpoint_step(path) == 0
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size, (2, 5)).astype(np.int32)
    want = JDecodeEngine.from_checkpoint(path, jp, JModel(jcfg, remat=False), max_seq=32,
                                         fused=True, return_logits=True).generate(toks, 4)
    kw = dict(max_seq=32, return_logits=True, device="cpu")
    for eng in (DecodeEngine.from_checkpoint(path, tp, tcfg, **kw),
                DecodeEngine.from_checkpoint(path, tcfg, tp, **kw),
                DecodeEngine.from_cluster(state, tcfg, **kw)):
        assert eng.num_chains == 3
        got = eng.generate(toks, 4)
        np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
        np.testing.assert_allclose(got.logits, np.asarray(want.logits), rtol=1e-4, atol=1e-4)
    paged = PagedDecodeEngine.from_checkpoint(path, tp, model=tcfg, num_slots=2,
                                              page_size=8, max_seq=32, device="cpu")
    assert paged.num_chains == 3
    one = str(tmp_path / "one.npz")
    jsave(one, jp)  # the JAX package's single model
    assert DecodeEngine.from_checkpoint(one, tp, tcfg, num_chains=2,
                                        device="cpu").num_chains == 2
