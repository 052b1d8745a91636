"""Production meshes of the port, as ``DeviceMesh``es.

Single pod: (data=16, model=16) — 256 ranks.
Multi-pod:  (pod=2, data=16, model=16) — 512 ranks; the ``pod`` axis is
the slow-link analogue of the paper's Internet links — batch / FSDP
traffic stays inside a pod, only the gradient all-reduce crosses pods.

The shapes and axis names are ``repro.launch.mesh``'s, so a dry-run
record of either package names the same mesh.  The dry-run has one
process and no cluster: ``make_production_mesh`` builds its mesh over a
"fake" process group (collectives return at once and move nothing),
whose default group is global state of the process.  So the dry-run runs
in a process of its own, or calls ``teardown`` when done.  Functions,
not module-level constants: importing this module touches no
process-group state.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch import DeviceLike, resolve_device


def fake_world(world_size: int) -> None:
    """Make the default process group a fake one of ``world_size`` ranks
    (this process is rank 0), replacing a fake group of another size."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if (dist.get_backend() == "fake"
                and dist.get_world_size() == world_size):
            return
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is initialized; the "
                               "dry-run's fake mesh needs a process of its "
                               "own")
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=0, world_size=world_size,
                            store=FakeStore())


def teardown() -> None:
    """Destroy the default process group, if any."""
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device_type: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over a fake process
    group of prod(shape) ranks.  Building a "cuda" mesh initializes no
    device backend, so it works on a machine with no GPU."""
    fake_world(math.prod(shape))
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    return make_mesh(*production_shape(multi_pod), device_type=device_type)


def make_host_mesh(n_stages: int = 0, *,
                   device: DeviceLike = None) -> DeviceMesh:
    """One-axis ("stage",) mesh over the ranks of the initialized default
    process group (gloo processes, say) — for ``spmd_pipeline``, not for
    the dry-run.  Its ranks compute on the card unless ``device="cpu"``
    is passed; without a GPU that request raises."""
    n = dist.get_world_size()
    return init_device_mesh(resolve_device(device).type, (n_stages or n,),
                            mesh_dim_names=("stage",))


class AbstractMesh:
    """A mesh's shape and axis names with no process group behind it
    (JAX's ``AbstractMesh``): enough for the sharding rules
    (``launch/shardings.py``) and per-chip byte counts, not for
    DTensors."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        self.shape = tuple(shape)
        self.mesh_dim_names = tuple(axes)
        self.ndim = len(self.shape)

    def size(self, mesh_dim: Optional[int] = None) -> int:
        return (math.prod(self.shape) if mesh_dim is None
                else self.shape[mesh_dim])


def production_shape(multi_pod: bool = False):
    """(shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def axis_sizes(mesh: DeviceMesh) -> Dict[str, int]:
    """{axis name: size}: JAX's ``mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    """Axes used for batch/data parallelism ('pod' joins 'data' if present)."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def model_axis(mesh: DeviceMesh) -> str:
    return "model"
