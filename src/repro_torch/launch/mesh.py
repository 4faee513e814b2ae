"""Production mesh builders. Functions, not module constants: importing
this module touches no process group.

The port of ``repro.launch.mesh``. The JAX package's pod is 16 x 16 = 256
chips and its multi-pod mesh two of them; here the same chip counts are
H100 GPUs: (32, 8) ``("data", "model")``, 256 GPUs, and (2, 32, 8)
``("pod", "data", "model")``, 512. The model axis is one 8-GPU NVLink
node; the data and pod axes cross InfiniBand
(``roofline.analysis.LINK_BW``).

The dry run needs no card: ``init_fake_process_group`` starts the fake
backend of ``torch.testing._internal.distributed.fake_pg`` (each
collective returns at once, nothing is sent), on which a ``DeviceMesh`` of
any size can be made in one process.
"""
from __future__ import annotations

PRODUCTION_SHAPE = (32, 8)
MULTI_POD_SHAPE = (2, 32, 8)


def make_production_mesh(*, multi_pod: bool = False, device_type="cpu"):
    """(32, 8) ``("data", "model")``, or (2, 32, 8) ``("pod", "data",
    "model")`` with ``multi_pod``, on the default process group, whose
    world size must be the mesh's."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = MULTI_POD_SHAPE if multi_pod else PRODUCTION_SHAPE
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_debug_mesh(n_data: int = 2, n_model: int = 4, device_type="cpu"):
    """A small (n_data, n_model) ``("data", "model")`` mesh (8 ranks by
    default) for tests."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=("data", "model"))


def dp_axes(mesh) -> tuple:
    """All data-parallel axes of a mesh ('pod' included when present)."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def init_fake_process_group(world_size: int, rank: int = 0) -> None:
    """Start the default process group on the fake backend with
    ``world_size`` ranks, this process as ``rank``: what the dry run lowers
    on in place of a cluster."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
