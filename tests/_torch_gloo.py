"""The rendezvous of the port's multi-process CPU tests (gloo).

Each spawned group meets through a file in its test's own temporary
directory, which no other process can take.  A TCP port found free and
handed to the ranks could be taken by another test's group first when
the suite runs in several workers.
"""
import os


def rendezvous(directory) -> str:
    """The ``init_method`` of one group: file ``rdzv`` in ``directory``, a
    directory of the test's own that this group alone uses."""
    return "file://" + os.path.join(os.fspath(directory), "rdzv")


def init_gloo(init_method: str, rank: int, world: int) -> None:
    """Join rank ``rank`` of ``world`` to the gloo group at
    ``init_method``."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=init_method, rank=rank,
                            world_size=world)
