"""Production mesh construction (twin of ``repro.launch.mesh``).

A ``torch.distributed.device_mesh.DeviceMesh`` with named dimensions
replaces ``jax.make_mesh``. A mesh is built over the *current* process
group, which the caller initialises: NCCL with one rank a card on GPUs,
or, to build the production shapes in one process without any card, a
fake group over ``torch.testing._internal.distributed.fake_pg.FakeStore``
(``init_fake_group``). Importing this module touches no device state.

Topology: 16 x 16 = 256 devices; ``multi_pod`` adds a leading pod axis
(2 pods = 512 devices). Axis roles:
  * pod   — data-parallel replica sets;
  * data  — batch / FSDP-weight sharding inside a pod;
  * model — tensor / expert / sequence parallel dimension.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _device_type() -> str:
    """``cuda`` for an NCCL group, ``cpu`` for any other backend."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_host_test_mesh(shape=(1, 1), axes=("data", "model")
                        ) -> DeviceMesh:
    """A small mesh over the current process group's ranks."""
    return init_device_mesh(_device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def init_fake_group(world_size: int) -> None:
    """A fake process group of ``world_size`` ranks in this process (rank
    0), enough to build a mesh of that size and shard ``meta`` tensors
    over it; no collective runs. Destroy it with
    ``torch.distributed.destroy_process_group()`` before building a mesh
    of another size."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def axis_sizes(mesh: DeviceMesh) -> dict[str, int]:
    """``mesh.shape`` of the reference: axis name -> size."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def dp_axes(mesh: DeviceMesh) -> tuple[str, ...]:
    """The data-parallel axes of a mesh (pod-aware)."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
