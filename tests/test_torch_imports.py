"""The port stands alone: ``repro_torch``, ``chip_smoke.py``, the port's
examples (``examples/torch_*.py``) and its timeline CLI
(``scripts/torch_obstool.py``) import neither ``jax`` nor anything of the
JAX package ``repro``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted(ROOT.glob("examples/torch_*.py"))
              + [ROOT / "scripts" / "torch_obstool.py"])


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_and_no_repro_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {mod}"


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch.cluster.paged, repro_torch.cluster.decode\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.build\n"
        "import repro_torch.weights, repro_torch.configs\n"
        "import repro_torch.core, repro_torch.samplers, repro_torch.data\n"
        "import repro_torch.train.engine, repro_torch.train.loop\n"
        "import repro_torch.launch.train, repro_torch.kernels.rng\n"
        "import repro_torch.kernels.langevin_update, repro_torch.kernels.delay_gather\n"
        "import repro_torch.metrics, repro_torch.experiments\n"
        "import repro_torch.core.potentials, repro_torch.core.theory\n"
        "import repro_torch.cluster.schedule, repro_torch.cluster.ensemble\n"
        "import repro_torch.cluster.executor, repro_torch.data.pipeline\n"
        "import repro_torch.checkpoint, repro_torch.faults\n"
        "import repro_torch.cluster.serve, repro_torch.models.predictive\n"
        "import repro_torch.models.moe, repro_torch.models.ssm\n"
        "import repro_torch.models.xlstm\n"
        "import repro_torch.analysis, repro_torch.analysis.instrument\n"
        "import repro_torch.analysis.cost, repro_torch.obs.timeline\n"
        "import repro_torch.launch.steps, repro_torch.launch.flop_cost\n"
        "import repro_torch.launch.roofline, repro_torch.launch.dryrun\n"
        "import repro_torch.launch.mesh\n"
        "from repro_torch.data import Prefetcher, make_specs\n"
        "from repro_torch.configs import SHAPES, all_archs, get_shape\n"
        "from repro_torch.models.common import partition_tree\n"
        f"sys.path.insert(0, {str(ROOT / 'scripts')!r})\n"
        "import torch_obstool\n"
        "from repro_torch.configs.base import ALIASES, get_arch, get_reduced\n"
        "assert all(get_arch(a).name == a and get_reduced(a) for a in ALIASES)\n"
        f"sys.path.insert(0, {str(ROOT / 'examples')!r})\n"
        "import torch_serve_quickstart, torch_serve_batch, torch_train_lm\n"
        "assert 'jax' not in {m.split('.')[0] for m in sys.modules\n"
        "                     if sys.modules[m] is not None}\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_placement_goes_through_torch_distributed_alone(tmp_path):
    """``launch.mesh``, ``utils`` and the placed engines reach placement
    through ``torch.distributed`` (a world of one gloo rank here), with JAX
    and the JAX package blocked."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import numpy as np, torch\n"
        "from repro_torch.launch.mesh import init_world, make_debug_mesh\n"
        "from repro_torch.utils import gather_chains, is_placed\n"
        "from repro_torch import samplers\n"
        "from repro_torch.cluster import ClusterEngine, ServeEngine\n"
        "from repro_torch.data import Prefetcher\n"
        f"init_world('cpu', {str(tmp_path / 'store')!r}, rank=0, world_size=1)\n"
        "mesh = make_debug_mesh(data=1, model=1)\n"
        "s = samplers.sgld('consistent', lambda p, b: p, gamma=0.1, sigma=0.0, tau=1)\n"
        "e = ClusterEngine(s, num_chains=2, mesh=mesh)\n"
        "st, _ = e.run(e.init(torch.ones(3), (0, 1)), steps=2)\n"
        "assert is_placed(st.params) and gather_chains(st.params).shape == (2, 3)\n"
        "srv = ServeEngine(predict_fn=lambda w, q: w @ q.T, params=torch.ones(2, 3),\n"
        "                  device='cpu', mesh=mesh)\n"
        "assert srv(np.ones((4, 3), np.float32)).mean.shape == (4,)\n"
        "pf = Prefetcher(lambda k: {'x': np.zeros((2, 3))}, (0, 1), device='cpu', mesh=mesh)\n"
        "assert is_placed(next(pf)['x'])\n"
        "pf.close()\n"
        "mods = {m for m in sys.modules if sys.modules[m] is not None}\n"
        "assert {'torch.distributed.device_mesh', 'torch.distributed.tensor'} <= mods\n"
        "assert not {m.split('.')[0] for m in mods} & {'jax', 'jaxlib', 'repro'}\n"
        "torch.distributed.destroy_process_group()\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
