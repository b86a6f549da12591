"""A 1-D data mesh over the processes of a ``torch.distributed`` group.

The port of ``ct_tpu/parallel/mesh.py``. JAX runs one SPMD program over a
``data`` axis of devices; the port runs one process a device, joined in a
process group (``parallel/distributed.py``). ``Mesh`` names this
process's place in it:

  * ``shard_batch`` keeps this rank's contiguous block of a batch's dim 0,
    the block that JAX's ``P("data")`` gives device ``rank``;
  * ``replicate`` broadcasts a model's parameters and buffers from rank 0;
  * ``all_reduce_flat`` sums a list of tensors over the ranks in one
    collective (the step's gradients, loss sums and N, and BatchNorm's
    running statistics, ``train/step.py``), and ``gather_blocks`` puts the
    ranks' blocks back together in rank order (the eval's detections).

Without a group ``make_mesh`` gives a mesh of one, on which every function
here is the identity, so the single-process path runs no collective.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

@dataclasses.dataclass(frozen=True)
class Mesh:
    """``world_size`` ranks, this one ``rank``, on ``device``; ``group`` is
    the process group (None for a mesh of one)."""

    world_size: int
    rank: int
    device: torch.device
    group: Any = None

    @property
    def distributed(self) -> bool:
        return self.world_size > 1

    @property
    def is_primary(self) -> bool:
        return self.rank == 0

    def block(self, n: int) -> slice:
        """This rank's rows of a dim of ``n``."""
        if n % self.world_size:
            raise ValueError(f"a batch of {n} does not divide over "
                             f"{self.world_size} ranks")
        b = n // self.world_size
        return slice(self.rank * b, (self.rank + 1) * b)


def make_mesh(n_data: Optional[int] = None, device=None) -> Mesh:
    """The mesh of the initialised process group (``n_data``, where given,
    must be its size), or a mesh of one without a group. ``device``: this
    rank's device (default: the CPU)."""
    device = torch.device("cpu" if device is None else device)
    if not (dist.is_available() and dist.is_initialized()):
        if n_data not in (None, 0, 1):
            raise ValueError(f"a mesh of {n_data} needs an initialised "
                             f"process group (parallel.distributed)")
        return Mesh(1, 0, device)
    world = dist.get_world_size()
    if n_data not in (None, 0, world):
        raise ValueError(f"a mesh of {n_data} in a group of {world} ranks")
    return Mesh(world, dist.get_rank(), device, dist.group.WORLD)


def shard_batch(mesh: Mesh, batch: Any) -> Any:
    """This rank's block of dim 0 of every array or tensor of ``batch`` (a
    dict, list or tuple of them, or one)."""
    if isinstance(batch, Mapping):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(mesh, v) for v in batch)
    return batch[mesh.block(batch.shape[0])]


def _flat_apply(tensors: Sequence[torch.Tensor], collective) -> None:
    """Run ``collective`` on one flat copy of ``tensors`` (one dtype and
    device) and copy the result back in place."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    collective(flat)
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].view_as(t))
        off += n


def _by_kind(tensors: Sequence[torch.Tensor]):
    kinds = {}
    for t in tensors:
        kinds.setdefault((t.dtype, t.device), []).append(t)
    return kinds.values()


def all_reduce_flat(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> int:
    """Sum ``tensors`` over the ranks in place, one collective for each
    dtype and device among them; returns the number of collectives."""
    if not mesh.distributed:
        return 0
    kinds = list(_by_kind(tensors))
    for same in kinds:
        _flat_apply(same, lambda f: dist.all_reduce(f, group=mesh.group))
    return len(kinds)


@torch.no_grad()
def replicate(mesh: Mesh, model: torch.nn.Module,
              extra: Sequence[torch.Tensor] = ()) -> torch.nn.Module:
    """Broadcast ``model``'s parameters and buffers, and the ``extra``
    tensors, from rank 0, one collective for each dtype; returns
    ``model``."""
    if mesh.distributed:
        tensors = (list(model.parameters()) + list(model.buffers())
                   + list(extra))
        for same in _by_kind(tensors):
            _flat_apply(same, lambda f: dist.broadcast(f, 0,
                                                       group=mesh.group))
    return model


def gather_blocks(mesh: Mesh, tensor: torch.Tensor) -> torch.Tensor:
    """The ranks' blocks of dim 0 concatenated in rank order, on every
    rank. Summed into a zero buffer (booleans as uint8), which gloo and
    NCCL both take on the CPU and on the card; exact for the eval's
    detections (x + 0 = x)."""
    if not mesh.distributed:
        return tensor
    b = tensor.shape[0]
    dtype = torch.uint8 if tensor.dtype == torch.bool else tensor.dtype
    full = torch.zeros((b * mesh.world_size,) + tuple(tensor.shape[1:]),
                       dtype=dtype, device=tensor.device)
    full[mesh.rank * b:(mesh.rank + 1) * b] = tensor
    dist.all_reduce(full, group=mesh.group)
    return full.to(tensor.dtype)


def bn_running_stats(model: torch.nn.Module) -> List[torch.Tensor]:
    """BatchNorm's running means and variances (not
    ``num_batches_tracked``, which is equal on every rank)."""
    return [buf for name, buf in model.named_buffers()
            if name.endswith(("running_mean", "running_var"))]
