"""The collectives of the multi-device step, on ``torch.distributed``.

Only ``all_reduce`` and ``broadcast`` are used: the two that gloo supports
on CUDA tensors as well as NCCL, so ranks that share one card (gloo) run
the same code as ranks with a card each (NCCL).  Over NCCL a rank's step
runs them inside its CUDA graph (``parallel/graphs.py``): they read nothing
on the host, the buffers they make come from the graph's pool at the
same address every replay, and :func:`average_grads` writes the averaged
gradient into the ``.grad`` tensors the backward filled.

- :func:`gather_slots`: each rank of a group holds one contiguous slice of
  a tensor's dim 1; the whole tensor is the group's ``all_reduce`` sum of
  zero-filled copies, each with its slice in place (``x + 0`` is exact).
  Its backward sums the cotangent over the group and hands each rank its
  slice, as a reduce-scatter does.
- :func:`average_grads`: every ``.grad`` of the given leaves, and any
  scalars, averaged over all ranks in ONE ``all_reduce`` per dtype.
- :func:`mesh_axis`: a rank's coordinate and the size along a mesh axis.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import torch
import torch.distributed as dist


def mesh_axis(mesh, name: str) -> Optional[Tuple[int, int]]:
    """(this rank's coordinate, size) along axis ``name`` of ``mesh``, or
    None when the mesh has no such axis."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return None
    dim = mesh.mesh_dim_names.index(name)
    return mesh.get_coordinate()[dim], mesh.size(dim)


def split_range(total: int, parts: int, index: int) -> Tuple[int, int]:
    """[start, stop) of part ``index`` of ``total`` items cut into ``parts``
    contiguous runs, the first ``total % parts`` runs one longer."""
    base, extra = divmod(total, parts)
    start = index * base + min(index, extra)
    return start, start + base + (1 if index < extra else 0)


class _SlotGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, part, start, total, group):
        ctx.start, ctx.stop, ctx.group = start, start + part.shape[1], group
        full = part.new_zeros((part.shape[0], total) + tuple(part.shape[2:]))
        full[:, ctx.start:ctx.stop] = part
        dist.all_reduce(full, group=group)
        return full

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g[:, ctx.start:ctx.stop], None, None, None


def gather_slots(part: torch.Tensor, start: int, total: int, group) -> torch.Tensor:
    """``part`` [R, k, ...] at columns [start, start + k) of a [R, total,
    ...] tensor whose other columns the other ranks of ``group`` hold →
    the whole tensor on every rank (see the module docstring).  Every rank
    of the group must call it, with a part that needs grad on all of them
    or on none."""
    return _SlotGather.apply(part, start, total, group)


def all_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over ``group`` (a new tensor; no gradient)."""
    x = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, group=group)
    return x


def average_grads(leaves: Iterable[torch.Tensor], scalars: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Average the ``.grad`` of every leaf that has one, in place, and the
    ``scalars`` over all ranks, in one ``all_reduce`` per dtype (float32
    alone in practice) → the averaged scalars.  The leaves must be the same
    on every rank, in the same order, with ``.grad`` set on the same ones."""
    grads = [t.grad for t in leaves if t.grad is not None]
    names = list(scalars)
    values = [scalars[k].detach().reshape(1).clone() for k in names]
    world = dist.get_world_size()
    by_dtype: Dict[torch.dtype, list] = {}
    for g in grads + values:
        by_dtype.setdefault(g.dtype, []).append(g)
    out = {}
    for dtype, ts in by_dtype.items():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat)
        flat /= world
        offset = 0
        for t in ts:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n
    for k, v in zip(names, values):
        out[k] = v.reshape(())
    return out
