"""The reference's weights and noise from a key: the port against the JAX
package on the CPU.

- ``init_params(cfg, PRNGKey(s), device="cpu")`` against
  ``repro.models.transformer.init_params(PRNGKey(s), cfg)``, leaf for leaf,
  for the reduced form of every registry config (each block kind, the gelu
  MLP, shared experts, tied embeddings, a frontend) in its own dtype: the
  drawn leaves (``jax.random.normal`` scaled and cast, ``uniform``) bit for
  bit, the count of unequal elements printed; ``dt_bias``'s ``log(expm1(
  exp(u)))`` in torch's float32 functions within 1e-6 relative (ATen's and
  XLA's ``exp`` may part in the last ulp); the xLSTM ``linspace`` biases
  within one ulp; the constant leaves equal.
- A bank of 3 chains is ``jax.vmap(init_params)`` over ``split(key, 3)``.
- A ``torch.Generator`` is refused; ``meta`` draws nothing.
- The default unfused noise (no ``noise=``) is the reference's
  ``noise_like`` bit for bit, and ``train_loop`` with no ``noise=`` gives
  the reference's loss history from the port's own weights of the same key
  (within rtol 1e-5: the forward's float rounding; the default run equals
  the ``noise="jax"`` run bit for bit).
- ``make_batch(..., device="cpu")`` is today's batch bit for bit.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.core.sgld import SGLDConfig as JSGLDConfig
from repro.data import make_batch as jax_make_batch
from repro.models.transformer import Model as JaxModel
from repro.models.transformer import init_params as jax_init
from repro.samplers.transforms import noise_like as jax_noise_like
from repro.train.loop import train_loop as jax_train_loop
from repro_torch import configs
from repro_torch.configs.base import ARCH_IDS
from repro_torch.core.sgld import SGLDConfig
from repro_torch.data import make_batch
from repro_torch.kernels import rng
from repro_torch.models.transformer import Model, init_params
from repro_torch.samplers.transforms import noise_like
from repro_torch.train.loop import train_loop
from repro_torch.weights import unit_chain
from torch_cases import one_cpu_thread  # noqa: F401

#: leaves computed, not drawn, that may part in the last ulp: dt_bias (torch's
#: exp / expm1 / log against XLA's) and the linspace biases
CLOSE = {"dt_bias": 1e-6, "gates_b": 2e-7, "bias": 2e-7}


def _pairs(jtree, ttree, path=""):
    """(path, reference leaf as numpy, port leaf) in the reference's order."""
    if isinstance(jtree, dict):
        assert sorted(jtree) == sorted(ttree), path
        return [x for k in sorted(jtree) for x in _pairs(jtree[k], ttree[k], f"{path}/{k}")]
    if isinstance(jtree, (list, tuple)):
        assert len(jtree) == len(ttree), path
        return [x for i, (a, b) in enumerate(zip(jtree, ttree))
                for x in _pairs(a, b, f"{path}/{i}")]
    return [(path, np.asarray(jtree.astype(jnp.float32)), ttree.float().numpy())]


def _leaves(tree) -> list:
    """A port tree's tensors in the order of :func:`_pairs`."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _same(a, b) -> bool:
    return all(x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(_leaves(a), _leaves(b)))


def _hold(jtree, ttree, what: str) -> None:
    unequal = {}
    for path, want, got in _pairs(jtree, ttree):
        assert got.shape == want.shape, f"{what} {path}"
        name = path.rsplit("/", 1)[-1]
        if name in CLOSE and not np.array_equal(got, want):
            np.testing.assert_allclose(got, want, rtol=CLOSE[name], atol=0,
                                       err_msg=f"{what} {path}")
            continue
        unequal[path] = int((got.view(np.uint32) != want.view(np.uint32)).sum())
    print(f"{what}: unequal elements by leaf {unequal}")
    assert not any(unequal.values()), f"{what}: {unequal}"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_params_is_the_references(arch):
    jcfg, tcfg = jconfigs.get_reduced(arch), configs.get_reduced(arch)
    assert jcfg.dtype == tcfg.dtype
    want = jax_init(jax.random.PRNGKey(3), jcfg)
    got = init_params(tcfg, rng.PRNGKey(3), device="cpu")
    for leaf in jax.tree_util.tree_leaves(want):
        assert leaf.dtype in (jnp.float32, jnp.bfloat16, jnp.float16)
    _hold(want, got, arch)
    # the other ways of naming the same key
    assert _same(init_params(tcfg, np.asarray(jax.random.PRNGKey(3)), device="cpu"), got)


@pytest.mark.parametrize("arch", ["qwen3-4b", "xlstm-1.3b", "hymba-1.5b"])
def test_bank_is_vmap_over_split_keys(arch):
    jcfg, tcfg = jconfigs.get_reduced(arch), configs.get_reduced(arch)
    keys = jax.random.split(jax.random.PRNGKey(8), 3)
    want = jax.vmap(lambda k: jax_init(k, jcfg))(keys)
    got = init_params(tcfg, 8, device="cpu", num_chains=3)
    _hold(want, got, f"{arch} x 3")


def test_init_params_refuses_a_generator_and_meta_draws_nothing():
    cfg = configs.get_reduced("qwen3-4b")
    with pytest.raises(TypeError, match="Generator"):
        init_params(cfg, torch.Generator(), device="cpu")
    meta = _leaves(init_params(cfg, 5, device="meta", num_chains=2))
    real = _leaves(init_params(cfg, 5, device="cpu", num_chains=2))
    assert [(m.shape, m.dtype) for m in meta] == [(r.shape, r.dtype) for r in real]
    assert all(m.device.type == "meta" for m in meta)


def test_default_noise_is_the_references():
    cfg = configs.get_reduced("qwen3-4b")
    params = init_params(cfg, 2, device="cpu")
    jparams = jax_init(jax.random.PRNGKey(2), jconfigs.get_reduced("qwen3-4b"))
    scale = np.float32(np.sqrt(2.0 * 1e-3 * 1e-2))
    want = jax_noise_like(jax.random.PRNGKey(6), jparams, jnp.float32(scale), jnp.float32)
    got = noise_like(rng.PRNGKey(6), params, scale, torch.float32)
    _hold(want, got, "noise_like")
    assert _same(noise_like(rng.PRNGKey(6), params, scale, torch.float32, "jax"), got)


def test_train_loop_default_noise_gives_the_references_loss_history():
    jcfg = replace(jconfigs.get_reduced("qwen3-4b"), dtype="float32")
    tcfg = replace(configs.get_reduced("qwen3-4b"), dtype="float32")
    shape = ("t", 16, 2, "train")
    steps, delays = 6, np.array([0, 1, 2, 1, 2, 0])
    kw = dict(mode="consistent", gamma=1e-3, sigma=1e-3, tau=2)
    _, want = jax_train_loop(
        JaxModel(jcfg, mesh=None), jax_init(jax.random.PRNGKey(0), jcfg), JSGLDConfig(**kw),
        lambda k: jax_make_batch(jcfg, jconfigs.ShapeConfig(*shape), k, "train"),
        steps, jax.random.PRNGKey(4), delays=delays, log_every=2, log_fn=lambda _: None)
    runs = {}
    for noise in (None, "jax"):
        extra = {} if noise is None else {"noise": noise}
        _, runs[noise] = train_loop(
            Model(tcfg, device="cpu"), unit_chain(init_params(tcfg, 0, device="cpu")),
            SGLDConfig(**kw),
            lambda k: make_batch(tcfg, configs.ShapeConfig(*shape), k, "train"),
            steps, 4, delays=delays, log_every=2, log_fn=lambda _: None, **extra)
    got = runs[None]
    assert got == runs["jax"]
    assert [s for s, _ in got] == [s for s, _ in want] == [0, 2, 4, 5]
    np.testing.assert_allclose([v for _, v in got], [float(v) for _, v in want],
                               rtol=1e-5)


@pytest.mark.parametrize("arch", ["qwen3-4b", "internvl2-1b"])
def test_make_batch_on_the_cpu_is_todays(arch):
    cfg = configs.get_reduced(arch)
    shape = configs.ShapeConfig("t", 48, 2, "train")
    default = make_batch(cfg, shape, rng.PRNGKey(9), "train")
    on_cpu = make_batch(cfg, shape, rng.PRNGKey(9), "train", device="cpu")
    want = jax_make_batch(jconfigs.get_reduced(arch), jconfigs.ShapeConfig("t", 48, 2, "train"),
                          jax.random.PRNGKey(9), "train")
    assert sorted(default) == sorted(on_cpu) == sorted(want)
    for name in want:
        assert on_cpu[name].device.type == "cpu"
        assert torch.equal(on_cpu[name], default[name])
        w = np.asarray(want[name])
        got = on_cpu[name].numpy()
        assert got.dtype == w.dtype and np.array_equal(got.view(np.uint32)
                                                       if got.dtype == np.float32 else got,
                                                       w.view(np.uint32)
                                                       if w.dtype == np.float32 else w)


@pytest.mark.parametrize("draw", ["jax_uniform", "jax_normal", "gumbel", "normal_rows",
                                  "categorical"])
def test_draws_route_by_device(draw):
    """On the CPU the plain path, on ``meta`` shapes alone, any other
    device refused (a card takes the kernels: ``tests/test_torch_kernels_cuda.py``)."""
    key = rng.PRNGKey(1)

    def call(device):
        if draw == "normal_rows":
            return rng.normal_rows([list(key)], (2, 3), device)
        if draw == "categorical":
            return rng.categorical(key, torch.zeros(2, 5, device=device))
        return getattr(rng, draw)(key, (2, 3), device=device)

    cpu = call("cpu")
    meta = call("meta")
    assert meta.device.type == "meta" and meta.shape == cpu.shape
    if draw != "categorical":  # no tensor can be made on a device this build lacks
        with pytest.raises(ValueError, match="no kernel for device"):
            call(torch.device("xpu"))
