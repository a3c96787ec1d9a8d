"""Seeded TL006 violations: axis names the statically visible mesh never
defined — the lookup fails, or the dimension silently replicates."""

from torch.distributed.device_mesh import init_device_mesh

from repro_torch.launch.mesh import _mesh, axis_size
from repro_torch.launch.steps import named

mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "model"))
chains = _mesh((4,), ("chains",))


def groups():
    tp = mesh.get_group("tensor")  # expect: TL006
    n = axis_size(chains, "data")  # expect: TL006
    return tp, n, mesh["pod"]  # expect: TL006


def specs():
    return named(mesh, {"w": ("fsdp", "model")})  # expect: TL006
