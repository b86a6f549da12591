"""Data parallelism over ``torch.distributed``: one process a device.

The port of ``ct_tpu/parallel``: ``mesh.py`` (``make_mesh``,
``shard_batch``, ``replicate`` and the step's reductions) and
``distributed.py`` (``initialize``, ``make_host_local_batch`` and the
launcher that spawns one worker a device)."""

from ct_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, make_mesh, replicate, shard_batch,
)
