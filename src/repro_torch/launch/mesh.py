"""Production mesh construction over ``torch.distributed``.

A function, not a module-level constant: importing this module touches no
device or process-group state (the dry-run installs a fake process group
before it builds a mesh).
"""
from __future__ import annotations


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """256 H100s as (data 32, model 8); 2 such pods (512) for multi-pod.
    The model axis is 8 wide so that its tensor-parallel traffic stays in
    one node's NVLink domain of 8 cards; "data" and "pod" cross nodes."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 32, 8) if multi_pod else (32, 8)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(data: int = 1, model: int = 1, device_type: str = "cuda"):
    """A (data, model) mesh over the current process group (the card,
    CPU ``gloo`` tests)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))
