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
- The placed dry run (a fake world in this process, destroyed after): each
  config's per-device parameter bytes on the production meshes, ``tp`` and
  ``"fsdp"``, against the reference's specs; a 1 x 1 mesh gives the
  unplaced figures; every config finishes on a 2 x 2 mesh.
- ``cache_spec_tree``: the reference's cache specs leaf by leaf through the
  port's chain axis, but the attention ring's, which splits KV heads
  (named here) where the reference splits ``head_dim``.
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
            real = make_batch(cfg, shape, rng.PRNGKey(0))
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
    """Every arch, shape and single switch (and none): the reference's
    ``sliding_window``, ``vocab_size``, ``param_sharding`` and ``opt_*``
    fields; ``"fsdp"`` on a MoE is refused on both sides."""
    opt_fields = [f.name for f in fields(get_arch("qwen3-4b")) if f.name.startswith("opt_")]
    assert opt_fields == ["opt_attn_head_shard", "opt_window_slice", "opt_unroll_layers"]
    keys = ["sliding_window", "vocab_size", "param_sharding"] + opt_fields
    for arch in IDS:
        for name in SHAPES:
            for opts in [()] + [(o,) for o in steps.OPTS]:
                cfg, jcfg = get_arch(arch), jc.get_arch(arch)
                if opts == ("fsdp",) and cfg.num_experts:
                    with pytest.raises(ValueError, match="dense"):
                        steps.adapt_config(cfg, get_shape(name), opts)
                    with pytest.raises(AssertionError, match="dense"):
                        jax_steps.adapt_config(jcfg, jc.get_shape(name), opts)
                    continue
                got = steps.adapt_config(cfg, get_shape(name), opts)
                want = jax_steps.adapt_config(jcfg, jc.get_shape(name), opts)
                assert {k: getattr(got, k) for k in keys} == \
                    {k: getattr(want, k) for k in keys}, (arch, name, opts)
    assert steps.adapt_config(get_arch("qwen3-4b"), get_shape("long_500k")) \
        .sliding_window == steps.LONG_CONTEXT_WINDOW == 8192
    with pytest.raises(ValueError, match="the switches are"):
        steps.adapt_config(get_arch("qwen3-4b"), get_shape("train_4k"), ("remat",))


def test_dry_run_with_window_slice_counts_only_the_in_window_chunks():
    """hymba-1.5b's ``train_4k`` on ``meta`` (a window of 1,024 over 512-token
    chunks: 8 query chunks, each reading the 3 in-window key chunks up to
    the diagonal, 21 pairs a layer): the windowed path counts the 43 other
    (query chunk, key chunk) pairs of the full square that one SDPA call
    without a window prices fewer — two products a pair forward, four
    backward, ``2 * 512 * 512 * 64`` FLOPs a head each — at every layer
    and sequence; ``--opts window_slice`` tags the record and counts the
    same, since the port reads only the in-window chunks either way."""
    cfg, shape = get_arch("hymba-1.5b"), get_shape("train_4k")
    plain = dryrun.run_combo("hymba-1.5b", "train_4k", verbose=False)
    sliced = dryrun.run_combo("hymba-1.5b", "train_4k", opts=("window_slice",),
                              verbose=False)
    square = dryrun.run_combo("hymba-1.5b", "train_4k", verbose=False,
                              cfg0=replace(cfg, sliding_window=None))
    assert sliced["mode"] == "sync+window_slice"
    assert sliced["counted"] == plain["counted"]
    pairs = 43 * cfg.num_layers * shape.global_batch
    saved = 6 * 2 * 512 * 512 * cfg.head_dim * cfg.num_heads * pairs
    assert square["counted"]["flops"] - plain["counted"]["flops"] == saved


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
    params = init_params(cfg, rng.PRNGKey(0), device="cpu", num_chains=1)
    batch = make_batch(cfg, shape, rng.PRNGKey(1))
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
    """One device's counts over the card's rates, its collective bytes over
    the link a mesh of that size is bounded by (NVLink within a node of 8,
    InfiniBand beyond); the global FLOPs the device's times the mesh's
    size."""
    r = roofline.analyze("x", Cost(flops=494.7e12, bytes=1.675e12), 494.7e12, 2,
                         collective_bytes=0.45e12)
    assert (r.flops_per_device, r.t_compute, r.t_memory) == (494.7e12, 0.5, 0.5)
    assert r.useful_ratio == 0.5 and "H100" in r.card
    assert r.t_collective == 1.0 and r.dominant == "collective" and "NVLink" in r.link
    r = roofline.analyze("x", Cost(flops=1.0, bytes=1.0), 1.0, 256, collective_bytes=50e9)
    assert r.t_collective == 1.0 and "InfiniBand" in r.link
    assert roofline.analyze("x", Cost(flops=1.0, bytes=1.0), 1.0).t_collective == 0.0
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
    params = init_params(cfg, None, device="meta")
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
    params = init_params(cfg, None, device="meta")
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
#: the configs with a tensor-parallel layout of their own (not an attention
#: stack of token prompts): hymba's SSD heads split by channel, the xLSTM
#: blocks replicated, a frontend's projection column-parallel; each is also
#: placed under the "fsdp" option beside it
OWN_LAYOUTS = ("hymba-1.5b", "xlstm-1.3b", "internvl2-1b", "musicgen-medium")


@pytest.mark.parametrize("arch", IDS)
def test_dry_run_of_every_arch_finishes_on_meta(arch, tmp_path):
    """Each config's train, prefill and decode steps placed on a ``data`` 2 x
    ``model`` 2 mesh (a fake world of 4 in this process): rank 0's step
    counted in the config's own layout, its figures per device; the
    configs with a layout of their own are counted under ``"fsdp"``
    beside it too."""
    t0 = time.perf_counter()
    layouts = [(), ("fsdp",)] if get_arch(arch).name in OWN_LAYOUTS else [()]
    with dryrun.placed((2, 2)) as m:
        for kind in ("train", "prefill", "decode"):
            shape = ShapeConfig(f"ci_{kind}", 128, 4, kind,
                                num_microbatches=2 if kind == "train" else 1)
            for opts in layouts:
                res = dryrun.run_combo(arch, shape.name, shape=shape,
                                       cfg0=get_reduced(arch), mesh=m, opts=opts,
                                       verbose=False)
                r = res["roofline"]
                assert "refused" not in res and res["num_devices"] == 4, res.get("refused")
                assert res["counted"]["flops"] > 0 and r["flops_per_device"] * 4 == \
                    pytest.approx(r["counted_flops_global"])
                assert r["dominant"] in ("compute", "memory", "collective") \
                    and "H100" in r["card"]
                assert res["memory"]["param_bytes"] > 0 and \
                    r["collective_bytes_per_device"] > 0
                if kind == "decode":
                    assert res["memory"]["cache_bytes"] > 0
                assert dryrun.save_result(res, str(tmp_path)).endswith(".json")
    assert not torch.distributed.is_initialized()
    assert time.perf_counter() - t0 < 60


def _jax_param_bytes(arch, axes, opts):
    """One chain's parameter bytes a device holds on a mesh of ``axes``,
    from the JAX package's ``adapt_config``, ``partition_tree`` and
    ``sanitize_spec`` (a namespace whose ``shape`` is the axis dict stands
    in for the mesh; they read nothing else); None where the reference
    refuses the option."""
    from repro.launch.steps import sanitize_spec as jax_sanitize

    try:
        jcfg = jax_steps.adapt_config(jc.get_arch(arch), jc.get_shape("train_4k"), opts)
    except AssertionError:
        return None
    jm = _JaxMeshShape(axes)
    params = jax.eval_shape(lambda k: jax_init(k, jcfg), jax.random.PRNGKey(0))
    specs = jax_partition_tree(params, jcfg.param_sharding, jax_mesh.fsdp_axes_for(jm),
                               cfg=jcfg, model_size=axes["model"])
    total = 0
    for sp, x in zip(_jax_specs(specs), jax.tree_util.tree_leaves(params)):
        sp = jax_sanitize(sp, x.shape, jm)
        split = int(np.prod([axes[a] for e in sp if e is not None
                             for a in ((e,) if isinstance(e, str) else e)]))
        total += int(np.prod(x.shape)) * x.dtype.itemsize // split
    return total


@pytest.mark.parametrize("arch", IDS)
def test_placed_param_bytes_equal_the_references_specs(arch):
    """Per-device parameter bytes of the placed dry run (rank 0's blocks) on
    the 16 x 16 and 2 x 16 x 16 production meshes and on 2 x 2, ``tp`` (the
    config's own layout: hymba's SSD leaves keep the reference's blocks at
    rest) and ``"fsdp"``: equal to those the JAX package's own specs give;
    ``"fsdp"`` on a MoE refused by both, and nothing else refused."""
    shape = get_shape("train_4k")
    for dims in ((2, 2), (16, 16), (2, 16, 16)):
        axes = dict(zip(("pod", "data", "model")[-len(dims):], dims))
        with dryrun.placed(dims) as m:
            for opts in ((), ("fsdp",)):
                want = _jax_param_bytes(arch, axes, opts)
                if want is None:
                    with pytest.raises(ValueError, match="dense"):
                        steps.adapt_config(get_arch(arch), shape, opts)
                    continue
                res = dryrun.run_combo(arch, shape.name, mesh=m, opts=opts, verbose=False)
                assert "refused" not in res, res.get("refused")
                assert res["memory"]["param_bytes"] == want, (dims, opts)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen3-4b", "kimi-k2-1t-a32b"])
def test_a_placed_dry_run_on_one_card_is_the_unplaced_one(arch, kind):
    """On a 1 x 1 mesh the placed model splits nothing: rank 0's step
    counts the FLOPs, bytes and memory of the unplaced step, and sends no
    collective."""
    cfg = replace(get_reduced(arch), dtype="float32")
    shape = ShapeConfig("t", 32, 4, kind, num_microbatches=2 if kind == "train" else 1)
    one = dryrun.run_combo(arch, "t", shape=shape, cfg0=cfg, verbose=False)
    with dryrun.placed((1, 1)) as m:
        placed = dryrun.run_combo(arch, "t", shape=shape, cfg0=cfg, mesh=m, verbose=False)
    assert placed["mesh"] == "1x1" and one["mesh"] == "1"
    for k in ("memory", "counted"):
        assert placed[k] == one[k], k
    assert placed["collectives"] == {} == one["collectives"]


def test_a_placed_dry_run_counts_the_collectives_by_axis():
    """Reduced qwen3-4b trained on ``data`` 2 x ``model`` 2: the
    tensor-parallel layout sends all-reduces over ``model`` (the row-parallel
    exits, the loss) and over ``data`` (the gradient's mean); under
    ``"fsdp"`` every weight is gathered over both axes (twice a layer: the
    forward and its recompute) and its gradient summed over them, and
    nothing runs on the activations."""
    cfg = replace(get_reduced("qwen3-4b"), dtype="float32")
    shape = ShapeConfig("t", 32, 8, "train", num_microbatches=2)
    with dryrun.placed((2, 2)) as m:
        tp = dryrun.run_combo("qwen3-4b", "t", shape=shape, cfg0=cfg, mesh=m,
                              verbose=False)
        fsdp = dryrun.run_combo("qwen3-4b", "t", shape=shape, cfg0=cfg, mesh=m,
                                opts=("fsdp",), verbose=False)
    assert set(tp["collectives"]) == {"all_reduce over model", "all_reduce over data"}
    assert set(fsdp["collectives"]) == {"all_gather over data+model",
                                        "all_reduce over data+model",
                                        "all_reduce over data", "all_reduce over model"}
    gathers = fsdp["collectives"]["all_gather over data+model"]
    # 2 microbatches x (2 layers x 7 weights x 2 + the embedding and the head)
    assert gathers["calls"] == 2 * (2 * 7 * 2 + 2)
    whole = roofline.tree_bytes(init_params(cfg, None, device="meta"))
    assert fsdp["memory"]["param_bytes"] * 4 == pytest.approx(whole, rel=0.01)  # 1/4 each
    assert fsdp["memory"]["param_bytes"] < tp["memory"]["param_bytes"] < whole
    assert fsdp["param_sharding"] == "fsdp_full"


def test_dryrun_cli(tmp_path, capsys):
    assert dryrun.main(["--arch", "qwen3-4b", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 0
    assert "OK: 1 combinations" in capsys.readouterr().out
    assert len(list(tmp_path.glob("*.json"))) == 1


def test_dryrun_cli_places_on_a_mesh_and_leaves_no_world(tmp_path, capsys):
    """``--mesh`` and ``--opts fsdp``: a MoE's refusal is written with its
    reason; no process group is left in the process."""
    import json

    assert dryrun.main(["--arch", "kimi-k2-1t-a32b", "--shape", "decode_32k",
                        "--mesh", "16x16", "--opts", "fsdp", "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "0 counted, 1 refused" in out and "dense" in out
    (path,) = tmp_path.glob("*.json")
    assert "dense" in json.loads(path.read_text())["refused"]
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# cache_spec_tree
# ---------------------------------------------------------------------------
def _without_chain(path: str, spec: tuple, stacked: bool) -> tuple:
    """The port's cache spec with its chain axis' entry taken out (the ring's
    ``pos`` has none)."""
    if path.endswith("pos"):
        return spec
    i = 1 if stacked else 0
    assert spec[i] is None
    return spec[:i] + spec[i + 1:]


def _paths(tree, path=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], f"{path}/{k}" if path
                                                           else k)]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in _paths(v, f"{path}/{i}" if path
                                                              else str(i))]
    return [(path, tree)]


@pytest.mark.parametrize("arch", IDS)
def test_cache_specs_equal_the_references(arch):
    """The port's decode-cache specs against the reference's
    ``cache_spec_tree`` on a 1 x 1 ``jax.make_mesh`` (nothing sanitized
    away), leaf by leaf through the port's chain axis, the rows over
    ``data``; the one difference by design is the attention ring's: the
    port splits its KV heads over ``model`` (its ring cache and page pool
    hold a rank's KV heads whole), the reference ``head_dim``."""
    cfg, jcfg = get_reduced(arch), jc.get_reduced(arch)
    shape = ShapeConfig("d", 64, 4, "decode")
    jshape = jc.ShapeConfig("d", 64, 4, "decode")
    jm = jax.make_mesh((1, 1), ("data", "model"))
    _, jshard = jax_steps.cache_spec_tree(JaxModel(jcfg, mesh=None), jcfg, jshape, jm,
                                          ("data",))
    model, _ = steps.build_model(cfg, shape, device="meta")
    cache, specs = steps.cache_specs(model, cfg, shape, mesh.MeshShape({"data": 1,
                                                                        "model": 1}),
                                     ("data",))
    want = dict(_paths(jax.tree_util.tree_map(lambda s: s.spec, jshard)))
    got = dict(_paths(specs, ""))
    assert set(got) == set(want)
    stacked = len(cfg.block_pattern) == 1
    for path, spec in got.items():
        spec = _canon(_without_chain(path, spec, stacked))
        ref = _canon(tuple(want[path]))
        ref = ref + (None,) * (len(spec) - len(ref))
        if "attn/" in path and not path.endswith("pos"):  # (L, B, S, KV, hd)
            assert ref[-2:] == (None, "model") and spec[-2:] == ("model", None), path
            spec, ref = spec[:-2], ref[:-2]
        assert spec == ref, (path, spec, ref)


def test_the_attention_cache_splits_kv_heads_not_head_dim():
    """The named difference, per card: qwen3-4b's ``decode_32k`` ring on
    16 x 16 (8 KV heads, ``model`` 16): the reference splits ``head_dim``
    128 into 16, the port's KV heads do not divide, so its spec replicates
    them (16 times the reference's bytes a card); on ``model`` 8 both split
    the ring eight ways, the same bytes a card."""
    cfg, shape = get_arch("qwen3-4b"), get_shape("decode_32k")
    model, _ = steps.build_model(cfg, shape, device="meta")
    for model_size, ratio in ((16, 16), (8, 1)):
        m = mesh.MeshShape({"data": 16, "model": model_size})
        cache, specs = steps.cache_specs(model, cfg, shape, m, ("data",))
        k, spec = cache["attn"]["k"], specs["attn"]["k"]
        L, C, B, S, KV, hd = k.shape
        held = k.numel() // 16 // (model_size if spec[4] == "model" else 1)
        reference = L * C * (B // 16) * S * KV * (hd // model_size)
        assert held == ratio * reference, (model_size, spec)


def test_cache_spec_tree_places_the_cache():
    """``cache_spec_tree`` is ``cache_specs``' specs as ``named`` places
    them on a ``DeviceMesh`` (a fake world of 4, destroyed after)."""
    from torch.distributed.tensor import Replicate, Shard

    cfg, shape = get_reduced("hymba-1.5b"), ShapeConfig("d", 64, 4, "decode")
    model, _ = steps.build_model(cfg, shape, device="meta")
    with dryrun.placed((2, 2)) as m:
        cache, placed = steps.cache_spec_tree(model, cfg, shape, m, ("data",))
        _, specs = steps.cache_specs(model, cfg, shape, m, ("data",))
        assert placed == steps.named(m, specs)
    assert placed["attn"]["k"] == [Shard(2), Shard(4)]  # rows, KV heads
    assert placed["attn"]["pos"] == [Replicate(), Replicate()]
    assert placed["ssm_h"] == [Shard(2), Shard(3)]  # rows, SSD heads
    assert not torch.distributed.is_initialized()
