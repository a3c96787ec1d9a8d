"""Batches from keys: the port's ``make_batch`` and the engines' key schedule
against the JAX package's, on the CPU.

- ``make_batch`` / ``token_stream`` bit for bit the reference's for every
  kind (``train``, ``prefill``, ``decode``), for a text config and for the
  two frontend configs (their stub embeddings: ``jax.random.normal``), at a
  reduced vocabulary and at qwen3-4b's 151,936 (``randint`` past 2**16).
- ``Engine.run`` and ``ClusterEngine.run`` hand ``batch_fn`` the reference's
  keys in order: a ``batch_fn`` that returns its key, and an oracle that
  returns its batch as aux, give the JAX engines' aux exactly; so does one
  that returns its key's normal draw.  A ``ClusterEngine`` resumed from a
  mid-run checkpoint hands the unbroken run's keys.  (A placed
  ``ClusterEngine``'s batches are held in ``tests/test_torch_placement.py``.)
- ``train_loop`` from one key, weights carried by ``from_jax_params``,
  ``noise="jax"``: the reference's loss history within rtol 1e-5 (float32;
  the batches, keys and noise bits are the reference's, only float rounding
  of the gradients separates the two).
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro import samplers as jsamplers
from repro.cluster import ClusterEngine as JClusterEngine
from repro.core.sgld import SGLDConfig as JSGLDConfig
from repro.data import make_batch as jax_make_batch
from repro.data.synthetic import token_stream as jax_token_stream
from repro.models.transformer import Model as JaxModel
from repro.models.transformer import init_params as jax_init
from repro.train.engine import Engine as JEngine
from repro.train.loop import train_loop as jax_train_loop
from repro_torch import configs, samplers
from repro_torch.cluster import ClusterEngine
from repro_torch.core.sgld import SGLDConfig
from repro_torch.data import make_batch, token_stream
from repro_torch.kernels import rng
from repro_torch.models.transformer import Model
from repro_torch.train.engine import Engine
from repro_torch.train.loop import train_loop
from repro_torch.weights import from_jax_params
from torch_cases import one_cpu_thread  # noqa: F401

D = 3


def _same(got, want, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    if want.dtype == np.float32:
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32),
                                      err_msg=name)
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("arch", ["qwen3-4b", "internvl2-1b", "musicgen-medium"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_make_batch_is_the_references_bit_for_bit(arch, kind):
    jcfg, tcfg = jconfigs.get_reduced(arch), configs.get_reduced(arch)
    key = jax.random.fold_in(jax.random.PRNGKey(5), 3)
    want = jax_make_batch(jcfg, jconfigs.ShapeConfig("t", 40, 3, kind), key)
    got = make_batch(tcfg, configs.ShapeConfig("t", 40, 3, kind), np.asarray(key))
    assert got.keys() == want.keys()
    assert ("frontend" in got) == (kind != "decode" and bool(tcfg.frontend))
    for name, v in want.items():
        if name == "cur_pos":
            assert got[name] == int(v)
        else:
            _same(got[name].numpy(), v, name)


@pytest.mark.parametrize("vocab", [500, 65536, 151936])
def test_token_stream_is_the_references_at_any_vocabulary(vocab):
    key = jax.random.PRNGKey(8)
    want = jax_token_stream(key, vocab, 4, 33)
    for k in (key, np.asarray(key), tuple(int(v) for v in np.asarray(key))):
        _same(token_stream(k, vocab, 4, 33).numpy(), want)
    # an int seed is PRNGKey(seed)
    _same(make_batch(configs.get_arch("qwen3-4b"), configs.ShapeConfig("t", 9, 2, "train"),
                     7)["tokens"].numpy(),
          jax_make_batch(jconfigs.get_arch("qwen3-4b"),
                         jconfigs.ShapeConfig("t", 9, 2, "train"),
                         jax.random.PRNGKey(7))["tokens"])


# -- the engines' key schedule ------------------------------------------------------------
def _key_oracles():
    """An oracle that ignores its batch and returns it as aux, in each
    package: with a batch_fn that returns its key, the aux is the keys."""
    def tgrad(p, b):
        return torch.zeros_like(p), {"batch": b}

    def jgrad(p, b):
        return jnp.zeros_like(p), {"batch": b}

    return tgrad, jgrad


@pytest.mark.parametrize("data", ["key", "normal"])
def test_engine_hands_batch_fn_the_references_keys(data):
    steps, chunk = 7, 3  # chunks of 3, 3 and 1
    tgrad, jgrad = _key_oracles()
    if data == "key":
        tfn, jfn = (lambda k: torch.tensor(k, dtype=torch.int64)), (lambda k: k)
    else:
        tfn, jfn = (lambda k: rng.jax_normal(k, (D,))), \
            (lambda k: jax.random.normal(k, (D,)))
    ts = samplers.sgld("sync", tgrad, gamma=0.1, sigma=0.0, has_aux=True)
    js = jsamplers.sgld("sync", jgrad, gamma=0.1, sigma=0.0, has_aux=True)
    _, aux = Engine(ts, batch_fn=tfn, chunk_size=chunk).run(
        ts.init(torch.zeros(D), rng.PRNGKey(0)), steps=steps, key=11)
    _, jaux = JEngine(js, batch_fn=jfn, chunk_size=chunk).run(
        js.init(jnp.zeros(D), jax.random.PRNGKey(0)), steps=steps,
        key=jax.random.PRNGKey(11))
    want = np.asarray(jaux["batch"])
    _same(aux["batch"], want.astype(np.int64) if data == "key" else want)
    if data == "key":  # each key once: no commit reuses another's batch
        assert len({tuple(r) for r in aux["batch"].tolist()}) == steps
    with pytest.raises(TypeError, match="torch.Generator"):
        Engine(ts, batch_fn=tfn).run(ts.init(torch.zeros(D), rng.PRNGKey(0)),
                                     steps=1, key=torch.Generator())


def _cluster(engine_cls, sampler, fn, **kw):
    return engine_cls(sampler, num_chains=4, chunk_size=2, collect_aux=True,
                      batch_fn=fn, **kw)


def test_cluster_engine_hands_batch_fn_the_references_keys_on_resume_too(tmp_path):
    steps, C = 6, 4
    tgrad, jgrad = _key_oracles()
    tfn = lambda k: torch.tensor(k, dtype=torch.int64)  # noqa: E731
    ts = samplers.sgld("sync", tgrad, gamma=0.1, sigma=0.0, has_aux=True)
    js = jsamplers.sgld("sync", jgrad, gamma=0.1, sigma=0.0, has_aux=True)
    eng = _cluster(ClusterEngine, ts, tfn)
    _, aux = eng.run(eng.init(torch.zeros(D), rng.PRNGKey(1)), steps=steps,
                     key=np.asarray(jax.random.PRNGKey(12)))
    jeng = _cluster(JClusterEngine, js, lambda k: k)
    _, jaux = jeng.run(jeng.init(jnp.zeros(D), jax.random.PRNGKey(1)), steps=steps,
                       key=jax.random.PRNGKey(12))
    assert aux["batch"].shape == (steps, C, 2)
    _same(aux["batch"], np.asarray(jaux["batch"]).astype(np.int64))

    # a run cut while making its third chunk's batches, after the checkpoint
    # at commit 4, then resumed: commits 4 and 5 get the unbroken run's keys
    made = []

    def failing(k):
        if len(made) == 2 * 2 * C:
            raise RuntimeError("cut")
        made.append(k)
        return tfn(k)

    path = str(tmp_path / "run.ckpt")
    cut = _cluster(ClusterEngine, ts, failing)
    with pytest.raises(RuntimeError, match="cut"):
        cut.run(cut.init(torch.zeros(D), rng.PRNGKey(1)), steps=steps, key=12,
                checkpoint_path=path)
    fresh = _cluster(ClusterEngine, ts, tfn)
    _, rest = fresh.resume(path, fresh.init(torch.zeros(D), rng.PRNGKey(1)),
                           steps=steps, key=12)
    _same(rest["batch"], aux["batch"][4:])


def test_train_loop_gives_the_references_loss_history():
    jcfg = replace(jconfigs.get_reduced("qwen3-4b"), dtype="float32")
    tcfg = replace(configs.get_reduced("qwen3-4b"), dtype="float32")
    jp = jax_init(jax.random.PRNGKey(0), jcfg)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    shape = ("t", 16, 2, "train")
    steps, delays = 6, np.array([0, 1, 2, 1, 2, 0])
    kw = dict(mode="consistent", gamma=1e-3, sigma=1e-3, tau=2)
    _, want = jax_train_loop(
        JaxModel(jcfg, mesh=None), jp, JSGLDConfig(**kw),
        lambda k: jax_make_batch(jcfg, jconfigs.ShapeConfig(*shape), k, "train"),
        steps, jax.random.PRNGKey(4), delays=delays, log_every=2, log_fn=lambda _: None)
    _, got = train_loop(
        Model(tcfg, device="cpu"), tp, SGLDConfig(**kw),
        lambda k: make_batch(tcfg, configs.ShapeConfig(*shape), k, "train"),
        steps, 4, delays=delays, log_every=2, log_fn=lambda _: None, noise="jax")
    assert [s for s, _ in got] == [s for s, _ in want] == [0, 2, 4, 5]
    np.testing.assert_allclose([v for _, v in got], [float(v) for _, v in want],
                               rtol=1e-5)
