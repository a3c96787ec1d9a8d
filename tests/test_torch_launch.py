"""The port's launch tooling against the JAX package's: ``SHAPES``,
``model_flops``, the FLOP count of a step, the SGLD step builders, the
partition rules, and the dry run on ``meta``.

- ``SHAPES`` and ``model_flops`` are equal exactly (arithmetic).
- Matmul FLOPs (``launch.flop_cost.step_cost`` on ``meta``) against the
  reference's ``launch.jaxpr_cost.step_cost`` on the same reduced config
  and shape (at most 512 positions, where both packages use plain
  attention; the reference's model without remat, which would recompute
  each layer's forward in its backward: the port keeps the activations).
  Train steps are equal, dense, MoE and frontend configs exactly.  Two
  differences are by design, and the test adds them back, computed from
  the config:
  * a prefill: the port unembeds only the position it returns, the
    reference every position — ``2 B (S - 1) d V``;
  * the reference's three-operand einsums (the SSD chunk scan, the mLSTM
    chunk) run their elementwise and outer products as ``dot_general``
    (2 FLOPs an element, and two more products each in the backward);
    ATen runs them as multiplies, which no FLOP formula counts.
- ``make_sgld_train_step`` at sigma 0: the new parameters within 1e-6, the
  loss within 1e-6 relative, a pipeline step's gradients within 1e-4 (the
  archs test's gradient tolerance).
- The partition specs, leaf by leaf, for every config and every
  ``param_sharding`` mode, against the reference's ``PartitionSpec``s, and
  through ``sanitize_spec`` on three meshes.
"""

import time
import types
from dataclasses import fields, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import repro.configs as jc
from repro.data import make_specs as jax_make_specs
from repro.launch import mesh as jax_mesh
from repro.launch import roofline as jax_roofline
from repro.launch import steps as jax_steps
from repro.launch.jaxpr_cost import step_cost as jax_step_cost
from repro.models.common import partition_tree as jax_partition_tree
from repro.models.transformer import Model as JaxModel
from repro.models.transformer import init_params as jax_init
from repro_torch import configs
from repro_torch.analysis import cost
from repro_torch.configs import SHAPES, ShapeConfig, get_arch, get_reduced, get_shape
from repro_torch.configs.base import ALIASES, ARCH_IDS
from repro_torch.data import make_batch, make_specs
from repro_torch.kernels import ops, rng
from repro_torch.launch import dryrun, mesh, roofline, steps
from repro_torch.launch.flop_cost import Cost, step_cost
from repro_torch.models.common import partition_tree
from repro_torch.models.transformer import init_params
from repro_torch.utils import tree_flatten
from repro_torch.weights import from_jax_params
from torch_cases import one_cpu_thread  # noqa: F401

IDS = sorted(ALIASES, key=lambda a: ARCH_IDS.index(ALIASES[a]))


# ---------------------------------------------------------------------------
# configs and model_flops
# ---------------------------------------------------------------------------
def test_shapes_equal_the_references():
    assert list(SHAPES) == list(jc.SHAPES)
    for name, s in SHAPES.items():
        assert get_shape(name) is s
        ref = jc.get_shape(name)
        assert {f.name: getattr(s, f.name) for f in fields(s)} == \
            {f.name: getattr(ref, f.name) for f in fields(ref)}
    assert [c.name for c in configs.all_archs()] == [c.name for c in jc.all_archs()]


def test_make_specs_are_make_batch_on_meta():
    for arch in ("qwen3-4b", "internvl2-1b"):
        cfg, jcfg = get_reduced(arch), jc.get_reduced(arch)
        for kind in ("train", "prefill", "decode"):
            shape = ShapeConfig("t", 64, 2, kind)
            spec = make_specs(cfg, shape)
            real = make_batch(cfg, shape, torch.Generator().manual_seed(0))
            ref = jax_make_specs(jcfg, jc.ShapeConfig("t", 64, 2, kind))
            assert spec.keys() == real.keys() == ref.keys()
            for k, v in spec.items():
                if k == "cur_pos":  # the decode step's host int
                    assert v == real[k] == 63 and ref[k].shape == ()
                    continue
                assert v.device.type == "meta"
                assert (v.shape, v.dtype) == (real[k].shape, real[k].dtype)
                assert tuple(v.shape) == ref[k].shape
                assert str(v.dtype).split(".")[-1] == str(ref[k].dtype)


def test_model_flops_kinds():
    cfg = get_arch("qwen3-4b")
    assert roofline.model_flops(cfg, get_shape("train_4k")) == \
        6.0 * cfg.param_count() * 256 * 4096
    assert roofline.model_flops(cfg, get_shape("prefill_32k")) == \
        2.0 * cfg.param_count() * 32 * 32768
    assert roofline.model_flops(cfg, get_shape("decode_32k")) == \
        2.0 * cfg.param_count() * 128


@pytest.mark.parametrize("arch", IDS)
def test_model_flops_equal_the_references(arch):
    cfg, jcfg = get_arch(arch), jc.get_arch(arch)
    for name in SHAPES:
        assert roofline.model_flops(cfg, get_shape(name)) == \
            jax_roofline.model_flops(jcfg, jc.get_shape(name))


def test_adapt_config_matches_the_references():
    for arch in IDS:
        for name in SHAPES:
            got = steps.adapt_config(get_arch(arch), get_shape(name), ("padvocab",))
            want = jax_steps.adapt_config(jc.get_arch(arch), jc.get_shape(name),
                                          ("padvocab",))
            assert (got.sliding_window, got.vocab_size) == \
                (want.sliding_window, want.vocab_size), (arch, name)
    assert steps.adapt_config(get_arch("qwen3-4b"), get_shape("long_500k")) \
        .sliding_window == steps.LONG_CONTEXT_WINDOW == 8192
    with pytest.raises(ValueError, match="mesh"):
        steps.adapt_config(get_arch("qwen3-4b"), get_shape("train_4k"), ("fsdp",))


# ---------------------------------------------------------------------------
# FLOP counts
# ---------------------------------------------------------------------------
def test_step_cost_counts_like_flop_counter_mode():
    x = torch.empty(64, 128, device="meta", requires_grad=True)
    w = torch.empty(128, 32, device="meta", requires_grad=True)

    def f(x, w):
        y = torch.einsum("ik,kj->ij", x, w)
        y.sum().backward()
        return y

    c = step_cost(f, x, w)
    with FlopCounterMode(display=False) as fc:
        f(x, w)
    assert c.flops == c.matmul_flops == fc.get_total_flops() == 3 * 2 * 64 * 128 * 32
    assert c.bytes > 0


def test_a_loop_counted_once_times_its_trips():
    """``repeated`` counts one iteration n times, its backward too, with the
    carry differentiated as in every iteration after the first."""
    w = torch.empty(64, 64, device="meta", requires_grad=True)

    def loop(x, n):
        def body(h):
            return torch.tanh(h @ w)
        h = cost.repeated(n, body, x)
        h.sum().backward()
        return h

    x = torch.empty(8, 64, device="meta")
    assert step_cost(loop, x, 10).matmul_flops == 10 * 3 * 2 * 8 * 64 * 64


def _gap(cfg, kind: str, B: int, S: int) -> float:
    """The matmul FLOPs the reference counts and the port, by design, does
    not (see the module docstring)."""
    k = 3 if kind == "train" else 1
    T = B * S
    gap = 0.0
    if kind == "prefill":
        gap += 2.0 * B * (S - 1) * cfg.d_model * cfg.vocab_size
    blocks = [cfg.block_pattern[i % len(cfg.block_pattern)] for i in range(cfg.num_layers)]
    H = cfg.num_heads
    for b in blocks:
        if b == "hymba_mlp":  # two outer products a chunk position
            gap += k * 2 * (2.0 * T * cfg.ssm_state * H)
        if b == "mlstm":  # scores x w, den_intra, two (t, h, d) and one (t, h) product
            dk = 2 * cfg.d_model // H
            gap += k * (2 * (2.0 * T * 64 * H) + 2 * (2.0 * T * H * dk) + 2.0 * T * H)
    return gap


def _jax_cost(arch, kind, B, S, mb):
    jcfg = jc.get_reduced(arch)
    shape = jc.ShapeConfig("t", S, B, kind, num_microbatches=mb)
    model = JaxModel(jcfg, remat=False)
    params = jax.eval_shape(lambda k: jax_init(k, jcfg), jax.random.PRNGKey(0))
    batch = jax_make_specs(jcfg, shape)
    if kind == "train":
        return jax_step_cost(jax_steps.make_sgld_train_step(model, shape), params, batch,
                             jax.ShapeDtypeStruct((2,), jnp.uint32))
    return jax_step_cost(jax_steps.make_prefill_step(model), params, batch)


MATMUL_ARCHS = ["qwen3-4b", "phi3.5-moe-42b-a6.6b", "hymba-1.5b", "xlstm-1.3b",
                "internvl2-1b", "kimi-k2-1t-a32b"]


MATMUL_CASES = ([(a, "train", 2, 128, 2) for a in MATMUL_ARCHS]
                + [(a, "prefill", 2, 128, 1) for a in MATMUL_ARCHS]
                + [(a, "train", 1, 512, 1) for a in ("qwen3-4b", "hymba-1.5b")])


@pytest.mark.parametrize("arch,kind,B,S,mb", MATMUL_CASES,
                         ids=[f"{a}-{k}-{S}" for a, k, _, S, _ in MATMUL_CASES])
def test_matmul_flops_equal_jaxpr_cost(arch, kind, B, S, mb):
    cfg = get_reduced(arch)
    shape = ShapeConfig("t", S, B, kind, num_microbatches=mb)
    step, args, _, _ = dryrun.step_and_args(cfg, shape)
    got = step_cost(step, *args)
    want = _jax_cost(arch, kind, B, S, mb)
    assert got.matmul_flops + _gap(cfg, kind, B, S) == want.matmul_flops


def test_meta_counts_equal_a_real_step_on_the_cpu():
    """One training step of the reduced qwen3-4b (two layers: the meta run
    counts one, twice) counts the same FLOPs on ``meta`` as run for real."""
    cfg = replace(get_reduced("qwen3-4b"), dtype="float32")
    shape = ShapeConfig("t", 32, 2, "train")
    meta_step, meta_args, _, _ = dryrun.step_and_args(cfg, shape)
    model, _ = steps.build_model(cfg, shape, device="cpu")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu", num_chains=1)
    batch = make_batch(cfg, shape, torch.Generator().manual_seed(1))
    real = step_cost(steps.make_sgld_train_step(model, shape), params, batch,
                     rng.PRNGKey(0))
    meta = step_cost(meta_step, *meta_args)
    assert (meta.flops, meta.matmul_flops) == (real.flops, real.matmul_flops)


def test_kernel_ops_take_their_meta_path_only_on_meta():
    """On ``meta`` the decode op returns shapes and reports its formula;
    on the CPU it is the plain version (its ATen ops counted as they run);
    any other device raises."""
    N, KV, G, hd, smax = 3, 2, 2, 64, 16

    def call(dev):
        q = torch.zeros(N, KV * G, hd, device=dev)
        kv = torch.zeros(N, KV, hd, device=dev)
        cache = torch.zeros(N, smax, KV, hd, device=dev)
        valid = torch.ones(smax, dtype=torch.int32, device=dev)
        return ops.fused_decode_step(q, kv, kv, cache, cache.clone(), valid, 3)

    c = step_cost(lambda: call("meta"))
    assert c.flops == 4.0 * N * KV * G * hd * smax and c.matmul_flops == 0
    o = call("meta")[0]
    assert o.device.type == "meta" and o.shape == (N, KV * G, hd)
    cpu = step_cost(lambda: call("cpu"))
    assert cpu.matmul_flops > 0  # the plain step's einsums
    with pytest.raises(ValueError, match="no kernel"):
        ops._route(types.SimpleNamespace(device=torch.device("xpu")), None, None)
    x = {"w": torch.zeros(1, 40, device="meta")}
    c = step_cost(lambda: ops.fused_langevin_update(x, x, [(1, 2)], [0.1], [0.2]))
    assert c.flops == cost.LANGEVIN_OPS * 40


def test_kernel_formulas_are_chip_smokes():
    import chip_smoke

    assert (cost.THREEFRY_OPS, cost.LANGEVIN_OPS, cost.DELAY_OPS) == \
        (chip_smoke.THREEFRY_OPS, chip_smoke.LANGEVIN_OPS, chip_smoke.DELAY_OPS)
    assert roofline.HBM_BW == chip_smoke.HBM_BYTES_PER_S


def test_roofline_terms_and_mfu():
    r = roofline.analyze("x", Cost(flops=989.4e12, bytes=3.35e12), 2, 494.7e12)
    assert (r.flops_per_device, r.t_compute, r.t_memory) == (494.7e12, 0.5, 0.5)
    assert r.useful_ratio == 0.5 and "H100" in r.card
    assert roofline.mfu(989.4e12, 2.0) == 0.5


# ---------------------------------------------------------------------------
# the SGLD step builders
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["sync", "pipeline"])
def test_sgld_train_step_matches_the_references(mode):
    jcfg = replace(jc.get_reduced("qwen3-4b"), dtype="float32")
    cfg = replace(get_reduced("qwen3-4b"), dtype="float32")
    shape = ShapeConfig("t", 32, 4, "train", num_microbatches=2)
    jshape = jc.ShapeConfig("t", 32, 4, "train", num_microbatches=2)
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 33)).astype(np.int32)
    jstep = jax_steps.make_sgld_train_step(JaxModel(jcfg, remat=False), jshape, mode,
                                           gamma=1e-3, sigma=0.0)
    model, _ = steps.build_model(cfg, shape, device="cpu")
    step = steps.make_sgld_train_step(model, shape, mode, gamma=1e-3, sigma=0.0)
    key = rng.PRNGKey(3)
    if mode == "sync":
        jnew, jloss = jstep(jparams, {"tokens": jnp.asarray(tokens)}, jax.random.PRNGKey(3))
        new, loss = step(params, {"tokens": torch.from_numpy(tokens)}, key)
    else:
        pend = jax.tree_util.tree_map(lambda p: jnp.full_like(p, 0.5), jparams)
        jnew, jgrads, jloss = jstep(jparams, pend, {"tokens": jnp.asarray(tokens)},
                                    jax.random.PRNGKey(3))
        tpend = from_jax_params(jax.tree_util.tree_map(np.asarray, pend), device="cpu")
        new, grads, loss = step(params, tpend, {"tokens": torch.from_numpy(tokens)}, key)
        for g, jg in zip(tree_flatten(grads)[0], jax.tree_util.tree_leaves(jgrads)):
            np.testing.assert_allclose(g[0].numpy(), np.asarray(jg), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    for p, jp in zip(tree_flatten(new)[0], jax.tree_util.tree_leaves(jnew)):
        np.testing.assert_allclose(p[0].numpy(), np.asarray(jp), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# mesh axes and partition rules
# ---------------------------------------------------------------------------
class _JaxMeshShape:
    def __init__(self, shape):
        self.shape = shape
        self.size = int(np.prod(list(shape.values())))


@pytest.mark.parametrize("axes", [{"data": 16, "model": 16},
                                  {"pod": 2, "data": 16, "model": 16},
                                  {"model": 4}, {"data": 3, "model": 2}])
def test_mesh_axes_equal_the_references(axes):
    m, jm = mesh.MeshShape(axes), _JaxMeshShape(axes)
    assert m.size == jm.size
    assert mesh.fsdp_axes_for(m) == jax_mesh.fsdp_axes_for(jm)
    for b in (1, 2, 3, 32, 128, 256):
        assert mesh.batch_axes_for(m, b) == jax_mesh.batch_axes_for(jm, b)


def _jax_specs(tree):
    from jax.sharding import PartitionSpec as P

    return jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(x, P))


def _canon(spec) -> tuple:
    """A spec with one-axis groups written as the axis (``("data",)`` is
    ``"data"``, as ``PartitionSpec`` normalises them)."""
    return tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p for p in spec)


def _spec_leaves(tree) -> list:
    """The port's specs in JAX's leaf order (a spec is a tuple: a leaf)."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _spec_leaves(tree[k])]
    if isinstance(tree, list):
        return [s for v in tree for s in _spec_leaves(v)]
    return [tree]


@pytest.mark.parametrize("arch", IDS)
def test_partition_specs_equal_the_references(arch):
    cfg, jcfg = get_arch(arch), jc.get_arch(arch)
    assert cfg.param_sharding == jcfg.param_sharding
    params = init_params(cfg, device="meta")
    jparams = jax.eval_shape(lambda k: jax_init(k, jcfg), jax.random.PRNGKey(0))
    for mode in ("tp", "fsdp_tp", "fsdp_full"):
        for fsdp_axes, model_size in ((("data",), None), (("pod", "data"), 16),
                                      (("data",), 4)):
            got = _spec_leaves(partition_tree(params, mode, fsdp_axes, cfg=cfg,
                                              model_size=model_size))
            want = _jax_specs(jax_partition_tree(jparams, mode, fsdp_axes, cfg=jcfg,
                                                 model_size=model_size))
            assert len(got) == len(want)
            assert [_canon(w) for w in want] == [_canon(g) for g in got], \
                (mode, fsdp_axes, model_size)


@pytest.mark.parametrize("arch", IDS)
def test_sanitized_specs_equal_the_references(arch):
    """``sanitize_spec`` over every leaf's spec, on the production meshes
    and a small one (a 32,064 vocabulary on ``model`` 16, 25 heads on 16, 3
    experts' worth of rows on 4): the reference's ``sanitize_spec``, leaf
    by leaf."""
    from repro.launch.steps import sanitize_spec as jax_sanitize
    from repro_torch.launch.steps import sanitize_spec

    cfg, jcfg = get_arch(arch), jc.get_arch(arch)
    params = init_params(cfg, device="meta")
    jparams = jax.eval_shape(lambda k: jax_init(k, jcfg), jax.random.PRNGKey(0))
    for axes in ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
                 {"data": 2, "model": 4}):
        fsdp = tuple(a for a in ("pod", "data") if a in axes)
        for mode in ("tp", "fsdp_tp", "fsdp_full"):
            specs = partition_tree(params, mode, fsdp, cfg=cfg, model_size=axes["model"])
            jspecs = jax_partition_tree(jparams, mode, fsdp, cfg=jcfg,
                                        model_size=axes["model"])
            got = [sanitize_spec(sp, tuple(x.shape), mesh.MeshShape(axes))
                   for sp, x in zip(_spec_leaves(specs), jax.tree_util.tree_leaves(params))]
            want = [jax_sanitize(sp, x.shape, _JaxMeshShape(axes))
                    for sp, x in zip(_jax_specs(jspecs), jax.tree_util.tree_leaves(jparams))]
            assert [_canon(w) + (None,) * (len(g) - len(w)) for w, g in zip(want, got)] \
                == [_canon(g) for g in got], (axes, mode)


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", IDS)
def test_dry_run_of_every_arch_finishes_on_meta(arch, tmp_path):
    t0 = time.perf_counter()
    for kind in ("train", "prefill", "decode"):
        shape = ShapeConfig(f"ci_{kind}", 128, 2, kind, num_microbatches=2 if kind == "train" else 1)
        res = dryrun.run_combo(arch, shape.name, shape=shape, cfg0=get_reduced(arch),
                               num_devices=4, verbose=False)
        r = res["roofline"]
        assert res["counted"]["flops"] > 0 and r["flops_per_device"] * 4 == \
            pytest.approx(res["counted"]["flops"])
        assert r["dominant"] in ("compute", "memory") and "H100" in r["card"]
        assert res["memory"]["param_bytes"] > 0
        if kind == "decode":
            assert res["memory"]["cache_bytes"] > 0
        assert dryrun.save_result(res, str(tmp_path)).endswith(".json")
    assert time.perf_counter() - t0 < 60


def test_dryrun_cli(tmp_path, capsys):
    assert dryrun.main(["--arch", "qwen3-4b", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 0
    assert "OK: 1 combinations" in capsys.readouterr().out
    assert len(list(tmp_path.glob("*.json"))) == 1
