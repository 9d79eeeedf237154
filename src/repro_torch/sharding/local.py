"""A kernel on DTensors runs per device, on each device's local shards
(the dry run's sharded trace, ``launch/dryrun.py``), as the kernel runs on
one device of a sharded program.

An operand's layout names its batch dim and its channel dim (the heads
of an attention, the channels of a scan), either None where it has none,
and the roles its value is summed over (a gradient shared over a split
it lacks).  ``per_device`` keeps the mesh dims that split the first
operand's batch or channel dim on every operand that has the dim; the
first mesh dim left over splits the channels if none does and they
divide (a free slice of a replicated operand, an all-to-all of one split
over the sequence, where the whole call would run on every device);
every other dim, the sequence above all, is replicated.  A result summed
over a split it lacks is ``Partial``.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

# (batch dim, channel dim, roles summed over)
Layout = Tuple[Optional[int], Optional[int], Tuple[str, ...]]


def is_dtensor(t) -> bool:
    return isinstance(t, DTensor)


def roles(lead: DTensor, chan: int) -> List[Optional[str]]:
    """Per mesh dim of ``lead``: "batch" if it splits dim 0, "chan" if it
    splits the channel dim ``chan`` (or is the first one left over and
    the channels divide by it), else None."""
    mesh = lead.device_mesh
    out = [("batch" if p.is_shard(0) else "chan" if p.is_shard(chan)
            else None) for p in lead.placements]
    if "chan" not in out:
        for m, role in enumerate(out):
            if role is None and lead.shape[chan] % mesh.size(m) == 0:
                out[m] = "chan"
                break
    return out


def channel_split(lead: DTensor, chan: int) -> int:
    """How many ways ``per_device`` splits ``lead``'s channel dim."""
    mesh = lead.device_mesh
    return math.prod(mesh.size(m) for m, role in enumerate(roles(lead, chan))
                     if role == "chan")


def per_device(fn: Callable, args: Sequence, layouts: Sequence[Layout],
               out_layouts: Sequence[Layout]):
    """``fn`` on each device's local shards of ``args`` (the first a
    DTensor; None and plain tensors pass, a plain tensor whole on every
    device, as a gradient autograd made as zeros), returning DTensors
    laid out by ``out_layouts``."""
    lead = args[0]
    mesh = lead.device_mesh
    args = tuple(DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
                 if isinstance(a, torch.Tensor) and not is_dtensor(a)
                 else a for a in args)
    rs = roles(lead, layouts[0][1])

    def place(layout: Layout):
        batch, chan, summed = layout
        return tuple(Shard(batch) if role == "batch" and batch is not None
                     else Shard(chan) if role == "chan" and chan is not None
                     else Partial() if role in summed else Replicate()
                     for role in rs)

    return local_map(
        fn, out_placements=tuple(place(lay) for lay in out_layouts),
        in_placements=tuple(place(lay) if is_dtensor(a) else None
                            for a, lay in zip(args, layouts)),
        redistribute_inputs=True, device_mesh=mesh)(*args)
