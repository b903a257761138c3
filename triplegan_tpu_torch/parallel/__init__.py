"""Data parallelism on ``torch.distributed``: the port of
``triplegan_tpu/parallel``. One process per card, the state replicated,
batches split on axis 0; each player's gradients averaged before its Adam,
batch-norm moments averaged (sync-BN), the REINFORCE baseline averaged over
every rank (``mesh.py``)."""

from triplegan_tpu_torch.parallel.mesh import Mesh, init_distributed, is_coordinator, make_mesh, mesh_for

__all__ = ["Mesh", "init_distributed", "is_coordinator", "make_mesh", "mesh_for"]
