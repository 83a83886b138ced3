"""Process-group initialization and the collectives the port runs (port of
``sibrar_tpu/parallel/distributed.py``).

The JAX package runs one controller per host and joins hosts with
``jax.distributed.initialize``. Here every device is a process of its own,
launched by ``python -m torch.distributed.run`` (torchrun), and
`initialize_distributed` joins them with
``torch.distributed.init_process_group``; `mesh.make_mesh` then lays the
world out as a (data, item) grid.

The backend follows a fixed rule:

- NCCL when every local rank has a card of its own;
- gloo when local ranks share a card (NCCL refuses two ranks on one device);
- gloo on the CPU.

Gloo takes CUDA tensors in the three collectives the port runs
(all-reduce, all-gather, broadcast; checked on the card by
``chip_smoke.py``'s mesh phase), so no collective copies through the host
by hand.

The collectives with a backward (`gather_rows_grad`, `all_reduce_grad`,
`reduce_forward`) give the data-parallel train step the gradient of the
global batch's loss once the gradients are averaged over the batch's ranks.
"""
from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# torchrun's environment; all three must be present to ask for a world
TRIGGERS = ("RANK", "WORLD_SIZE", "MASTER_ADDR")

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


class Solo:
    """A group of one rank: every collective over it is the identity. There
    is one, `SOLO`: copies and pickles give it back."""

    def __reduce__(self):
        return "SOLO"


SOLO = Solo()


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_main() -> bool:
    """Rank 0, or a single process: the one that writes run files."""
    return rank() == 0


def local_world_size() -> int:
    """Ranks on this node (torchrun's ``LOCAL_WORLD_SIZE``)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", world_size()))


def choose_backend(local_world: int) -> str:
    """NCCL when each of ``local_world`` local ranks has its own card, gloo
    when they share cards or there is none."""
    if not torch.cuda.is_available():
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= local_world else "gloo"


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None, *,
                           timeout_s: float = 600.0) -> bool:
    """Join the process group if the environment or the arguments ask for
    a world; returns False in a single process (nothing asked), True once
    joined (a second call is a no-op).

    torchrun's ``RANK``, ``WORLD_SIZE`` and ``MASTER_ADDR`` trigger it, or
    an explicit ``init_method`` (``tcp://...``, ``file://...``) with
    ``world_size`` and ``rank``. Each rank takes card ``LOCAL_RANK % count``
    (``init_device_mesh``'s rule) before joining. A failure to join raises:
    a world that was asked for never runs as one process."""
    explicit = init_method is not None
    auto = all(v in os.environ for v in TRIGGERS)
    if not (explicit or auto):
        return False
    if is_initialized():
        return True
    if explicit:
        if world_size is None or rank is None:
            raise ValueError("an explicit init_method needs world_size and "
                             "rank")
    else:
        init_method = "env://"
        world_size = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    backend = choose_backend(local_world)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    logger.info("torch.distributed: rank %d of %d, backend %s", rank,
                world_size, backend)
    return True


def group_size(group) -> int:
    if group is SOLO:
        return 1
    return dist.get_world_size(group) if is_initialized() else 1


def group_rank(group) -> int:
    if group is SOLO:
        return 0
    return dist.get_rank(group) if is_initialized() else 0


def all_reduce(t: torch.Tensor, op: str = "sum", group=None
               ) -> torch.Tensor:
    """``t`` reduced in place over ``group`` (None: the world); returns
    ``t``."""
    if group_size(group) > 1:
        dist.all_reduce(t, op=_OPS[op], group=group)
    return t


def all_gather(t: torch.Tensor, group=None) -> list[torch.Tensor]:
    """Every rank's ``t`` (same shape on all ranks), in group-rank order.
    The list form of ``dist.all_gather``, which every PyTorch version
    in use has."""
    if group_size(group) == 1:
        return [t]
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(group_size(group))]
    dist.all_gather(out, t, group=group)
    return out


def broadcast_object(obj):
    """Rank 0's ``obj`` (picklable) on every rank."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


# -------------------------------------------------- collectives with a backward
class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0; the backward sums the gradient over the
    group and keeps this rank's rows (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rows = x.shape[0]
        return torch.cat(all_gather(x, group))

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(g.contiguous().clone(), group=ctx.group)
        start = group_rank(ctx.group) * ctx.rows
        return g[start:start + ctx.rows], None


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the backward sums the gradient over it too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), group=group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), group=ctx.group), None


class _ReduceForward(torch.autograd.Function):
    """Sum over the group in the forward, identity in the backward
    (Megatron's row-parallel linear layer)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group=group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather_rows_grad(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's rows of ``x``, concatenated in group-rank order, with a
    gradient for this rank's rows."""
    if group_size(group) == 1:
        return x
    return _GatherRows.apply(x, group)


def all_reduce_grad(x: torch.Tensor, group) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    return _AllReduceSum.apply(x, group)


def reduce_forward(x: torch.Tensor, group) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    return _ReduceForward.apply(x, group)
