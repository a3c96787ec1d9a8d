"""The port's training engine and launcher against the JAX package's, on the CPU.

- ``Engine``: 6 fused W-Icon commits of the reduced qwen3-4b in float32
  (one chain, weights from the JAX init), in chunks of 4 (two chunk
  lengths), delays from ``simulate_async`` clipped to tau = 2, sigma 0.5.
  Losses agree within rtol 1e-5 and the final parameters within 1e-6 of
  the JAX ``Engine``'s; the delays, keys and noise bits are the JAX
  package's, so only float rounding separates the two.
- The launcher runs the port's training on the CPU when asked, and raises
  without a card when not (its default is ``--device cuda``).
"""

import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import samplers as jsamplers
from repro.configs import get_reduced as jax_reduced
from repro.core.delay_model import WorkerModel, simulate_async
from repro.models.transformer import Model as JaxModel
from repro.models.transformer import init_params as jax_init
from repro.train.engine import Engine as JaxEngine
from repro.train.loop import make_grad_fn as jax_grad_fn
from repro_torch import samplers
from repro_torch.configs import get_reduced
from repro_torch.core.delay import StalenessError
from repro_torch.kernels import rng
from repro_torch.launch import train as launch
from repro_torch.models.transformer import Model
from repro_torch.train.engine import Engine
from repro_torch.train.loop import make_grad_fn
from repro_torch.utils import tree_leaves
from repro_torch.weights import from_jax_params
from torch_cases import one_cpu_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
STEPS, CHUNK, TAU = 6, 4, 2


def test_engine_fused_wicon_matches_jax_engine():
    jcfg = replace(jax_reduced("qwen3-4b"), dtype="float32")
    tcfg = replace(get_reduced("qwen3-4b"), dtype="float32")
    jp = jax_init(jax.random.PRNGKey(0), jcfg)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    r = np.random.default_rng(4)
    tokens = r.integers(0, jcfg.vocab_size, (STEPS, 2, 17)).astype(np.int32)
    trace = simulate_async(WorkerModel(num_workers=8, seed=0), STEPS, seed=0)
    delays = np.minimum(trace.delays, TAU)
    assert delays.max() == TAU  # the run reads stale coordinates
    kw = dict(gamma=1e-3, sigma=0.5, tau=TAU, has_aux=True, fused=True)

    js = jsamplers.sgld("inconsistent", jax_grad_fn(JaxModel(jcfg, mesh=None)), **kw)
    jeng = JaxEngine(js, chunk_size=CHUNK)
    jstate, jaux = jeng.run(js.init(jp, jax.random.PRNGKey(5)), steps=STEPS,
                            batches={"tokens": jnp.asarray(tokens)},
                            delays=delays)

    ts = samplers.sgld("inconsistent", make_grad_fn(Model(tcfg, device="cpu")), **kw)
    eng = Engine(ts, chunk_size=CHUNK)
    state, aux = eng.run(ts.init(tp, rng.PRNGKey(5)), steps=STEPS,
                         batches={"tokens": tokens}, delays=delays)

    assert eng.num_traces == jeng.num_traces == 2
    assert aux["loss"].shape == (STEPS,)
    np.testing.assert_allclose(aux["loss"], np.asarray(jaux["loss"]), rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(jstate.params),
                    tree_leaves(state.params)):
        np.testing.assert_allclose(b[0].numpy(), np.asarray(a), rtol=0, atol=1e-6)
    assert state.step == STEPS
    assert state.key == tuple(np.asarray(jstate.key).tolist())

    with pytest.raises(StalenessError):  # a trace staler than the ring
        eng.run(state, steps=2, batches={"tokens": tokens},
                delays=np.array([0, TAU + 1]))


def test_launcher_trains_on_cpu_when_asked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen3-4b",
         "--reduced", "--device", "cpu", "--steps", "2", "--mode",
         "inconsistent", "--fused", "--tau", "2", "--batch", "2", "--seq", "32"],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "mode=inconsistent (fused)" in res.stdout
    assert "step     1 loss" in res.stdout


def test_launcher_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(["--arch", "qwen3-4b", "--reduced", "--steps", "1"])
