"""TL006 clean variant: every axis exists in its mesh (a dict's keys are
leaf names, not axes)."""

from torch.distributed.device_mesh import init_device_mesh

from repro_torch.launch.mesh import _mesh, axis_size
from repro_torch.launch.steps import named

mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "model"))
chains = _mesh((4,), ("chains",))


def groups():
    tp = mesh.get_group("model")
    n = axis_size(chains, "chains")
    return tp, n, mesh["data"], mesh.get_local_rank("model")


def specs():
    return named(mesh, {"w": ("data", "model"), "b": (None,)})
