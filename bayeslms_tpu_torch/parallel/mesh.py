"""The (dp, tp) layout of the ranks and its collectives, counterpart of
``bayeslms_tpu/parallel/mesh.py``.

One process is one rank and one device. A mesh lays the ranks of a joined
``torch.distributed`` group out as a dp x tp grid in the order
``np.reshape(ranks, (dp, tp))`` gives, so that tp is filled by adjacent
ranks (the JAX ``make_mesh``'s device order). Each JAX ``shard_map`` body
becomes code that every rank runs on its own shard, and what XLA inserted
between the shards are the collectives below, over the mesh's dp and tp
groups:

- ``all_reduce``, ``all_gather``, ``broadcast``, ``gather_object``: plain
  collectives, no gradient;
- ``psum`` and ``gather``: their autograd forms. ``gather``'s transpose
  is the slice of the sum of the members' cotangents; ``psum``'s is the
  sum of them: the gradient of the sum of every member's own loss, as a
  JAX collective transposes;
- ``mean_``: the in-place mean of a list of tensors over an axis, in one
  flat buffer.

Each collective is a named range in a profile (``mesh.all_reduce``,
``mesh.all_gather``, ``mesh.broadcast``, ``mesh.gather_object``), its
host staging included, so that a trace of a step gives the share of the
step spent in collectives.

The backend is the caller's: NCCL where each rank has its own card, gloo
on the CPU. Gloo takes CUDA tensors for only some collectives, so where
the ranks run gloo with CUDA tensors (two ranks on one card, which NCCL
refuses) every collective here stages through the host: copy to the CPU,
reduce there, copy back. That is decided by the mesh (``Mesh.staged``),
never by retrying a refused call.

``param_spec`` is the JAX path rule that names the axis a parameter splits
over (``("tp", None)``, ``("tp",)`` or ``()``); ``params_specs`` maps it
over a parameter tree. ``batch_columns`` and ``hidden_rows`` cut this
rank's contiguous block out of a (T, B) batch and an (L, B, H) state, the
``batch_sharding`` and ``hidden_sharding`` of the JAX module;
``replicated`` is the empty spec.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

Spec = Tuple[Optional[str], ...]


def rank_grid(dp: int, tp: int) -> np.ndarray:
    """The ranks as the (dp, tp) grid: rank r sits at (r // tp, r % tp)."""
    return np.arange(dp * tp).reshape(dp, tp)


@dataclass
class Mesh:
    """This rank's view of the (dp, tp) grid: its coordinates, its dp and
    tp groups (None where the axis has one member), its device, the
    backend."""

    dp: int
    tp: int
    rank: int
    device: torch.device
    backend: str
    dp_group: Any = None
    tp_group: Any = None

    @property
    def dp_index(self) -> int:
        return self.rank // self.tp

    @property
    def tp_index(self) -> int:
        return self.rank % self.tp

    @property
    def staged(self) -> bool:
        """True where the collectives go through the host: gloo ranks
        holding CUDA tensors."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def size(self, axis: str) -> int:
        return {"dp": self.dp, "tp": self.tp, "all": self.dp * self.tp}[axis]

    def index(self, axis: str) -> int:
        return {"dp": self.dp_index, "tp": self.tp_index,
                "all": self.rank}[axis]

    def group(self, axis: str):
        return {"dp": self.dp_group, "tp": self.tp_group,
                "all": None}[axis]


def make_mesh(dp: Optional[int] = None, tp: int = 1,
              device=None) -> Mesh:
    """The (dp, tp) mesh of the joined process group, whose world must be
    dp * tp (dp defaults to world // tp). Every rank calls it, in the same
    order as its other collectives: it creates the dp and tp groups.
    ``device``: this rank's device; by default its card (``LOCAL_RANK``)
    under NCCL, else the CPU."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh: no process group; launch the ranks with "
            "parallel.multihost.spawn (or torchrun and "
            "initialize_multihost)")
    world, rank = dist.get_world_size(), dist.get_rank()
    dp = world // tp if dp is None else dp
    if dp < 1 or tp < 1 or dp * tp != world:
        raise ValueError(f"make_mesh: dp {dp} x tp {tp} != {world} ranks")
    backend = dist.get_backend()
    if device is None:
        from .multihost import local_rank

        device = f"cuda:{local_rank()}" if backend == "nccl" else "cpu"
    grid = rank_grid(dp, tp)
    groups = {}
    # every rank creates every group, in one order
    for axis, members in (("dp", [grid[:, t] for t in range(tp)]),
                          ("tp", [grid[d] for d in range(dp)])):
        for m in members:
            g = dist.new_group([int(r) for r in m]) if len(m) > 1 else None
            if rank in m:
                groups[axis] = g
    return Mesh(dp=dp, tp=tp, rank=rank, device=torch.device(device),
                backend=backend, dp_group=groups["dp"],
                tp_group=groups["tp"])


# ------------------------------------------------------------ collectives

def _host(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu() if mesh.staged else t.detach()


def _back(mesh: Mesh, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return t.to(like.device) if mesh.staged else t


def all_reduce(mesh: Mesh, t: torch.Tensor, axis: str,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new tensor: ``t`` reduced over ``axis``'s members."""
    if mesh.size(axis) == 1:
        return t.detach().clone()
    with record_function("mesh.all_reduce"):
        x = _host(mesh, t).clone()
        dist.all_reduce(x, op=op, group=mesh.group(axis))
        return _back(mesh, x, t)


def all_gather(mesh: Mesh, t: torch.Tensor, axis: str,
               dim: int = 0) -> torch.Tensor:
    """The members' ``t`` (one shape) concatenated along ``dim`` in the
    order of their index on ``axis``."""
    n = mesh.size(axis)
    if n == 1:
        return t.detach().clone()
    with record_function("mesh.all_gather"):
        x = _host(mesh, t).contiguous()
        out = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(out, x, group=mesh.group(axis))
        return _back(mesh, torch.cat(out, dim=dim), t)


def broadcast(mesh: Mesh, t: torch.Tensor, axis: str = "all") -> torch.Tensor:
    """The value of ``axis``'s first member, on every member."""
    if mesh.size(axis) == 1:
        return t
    with record_function("mesh.broadcast"):
        x = _host(mesh, t).clone()
        g = mesh.group(axis)
        src = 0 if g is None else dist.get_global_rank(g, 0)
        dist.broadcast(x, src=src, group=g)
        return _back(mesh, x, t)


def gather_object(mesh: Mesh, obj, axis: str = "all") -> list:
    """Every member's picklable ``obj``, in the order of their index."""
    n = mesh.size(axis)
    if n == 1:
        return [obj]
    out = [None] * n
    with record_function("mesh.gather_object"):
        dist.all_gather_object(out, obj, group=mesh.group(axis))
    return out


def barrier(mesh: Mesh) -> None:
    if mesh.dp * mesh.tp > 1:
        dist.barrier()


def mean_(mesh: Mesh, tensors: Sequence[torch.Tensor], axis: str) -> None:
    """Each tensor of ``tensors`` (one dtype) replaced in place by its mean
    over ``axis``, through one flat buffer."""
    n = mesh.size(axis)
    if n == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    flat = all_reduce(mesh, flat, axis) / n
    i = 0
    for t in tensors:
        t.copy_(flat[i:i + t.numel()].view_as(t))
        i += t.numel()


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_reduce(mesh, x, axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(ctx.mesh, g, ctx.axis), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim, ctx.n = mesh, axis, dim, x.shape[dim]
        return all_gather(mesh, x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        s = all_reduce(ctx.mesh, g, ctx.axis)
        i = ctx.mesh.index(ctx.axis)
        return s.narrow(ctx.dim, i * ctx.n, ctx.n).contiguous(), None, None, \
            None


def psum(mesh: Mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """Differentiable sum over ``axis``; its backward sums the members'
    cotangents."""
    return x if mesh.size(axis) == 1 else _Psum.apply(x, mesh, axis)


def gather(mesh: Mesh, x: torch.Tensor, axis: str,
           dim: int = 0) -> torch.Tensor:
    """Differentiable ``all_gather`` along ``dim``; its backward is this
    member's slice of the sum of the members' cotangents."""
    return x if mesh.size(axis) == 1 else _Gather.apply(x, mesh, axis, dim)


# ------------------------------------------------------------------ rules

def param_spec(path: Tuple[str, ...], shape: Tuple[int, ...], tp: int) -> Spec:
    """The axes one parameter splits over, the JAX package's path rules
    (only where the dimension divides by tp): the embedding / decoder
    (V, E) and decoder_b over the vocabulary; the Transformer's first FFN
    and q/k/v kernels over their output features, the second FFN and o_net
    over their input (BayesDense's (out, in) means and lgstds over in);
    the LSTM gate blocks (G H, in) and their biases over the gate rows;
    everything else replicated, ``()``."""
    name = path[-1]
    joined = "/".join(path)

    def ok(dim):
        return dim % tp == 0 and tp > 1

    if name in ("embedding", "decoder_w", "decoder_b"):
        return ("tp",) if ok(shape[0]) else ()
    if "linear1" in joined or "qkv_net" in joined or "q_net" in joined or (
            "k_net" in joined or "v_net" in joined):
        if name == "kernel" and len(shape) == 2 and ok(shape[1]):
            return (None, "tp")
        if name == "bias" and ok(shape[0]):
            return ("tp",)
        return ()
    if "linear2" in joined or "o_net" in joined:
        if name == "kernel" and len(shape) == 2 and ok(shape[0]):
            return ("tp", None)
        if name in ("weight_mean", "weight_lgstd") and len(shape) == 2 \
                and ok(shape[1]):
            return (None, "tp")
        return ()
    if ("w_ih" in name or "w_hh" in name or "weight_ih" in name
            or "weight_hh" in name or "weights_ih" in name
            or "weights_hh" in name):
        if len(shape) == 2 and ok(shape[0]):
            return ("tp", None)
        return ()
    if ("b_ih" in name or "b_hh" in name or "bias_ih" in name
            or "bias_hh" in name):
        return ("tp",) if ok(shape[0]) else ()
    return ()


def params_specs(tp: int, params: Mapping) -> dict:
    """``param_spec`` over a nested parameter tree (the JAX layout,
    ``core/checkpoint.py`` ``params_to_jax``): a tree of axis tuples."""
    def walk(node, path):
        if isinstance(node, Mapping):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return param_spec(path, tuple(np.shape(node)), tp)
    return walk(params, ())


def replicated() -> Spec:
    return ()


def batch_columns(mesh: Mesh, x: torch.Tensor, axis: str = "dp",
                  dim: int = 1) -> torch.Tensor:
    """This rank's contiguous block of ``x`` along ``dim`` (the batch of a
    (T, B) window), split over ``axis``: "dp", or "all" for the dp x tp
    split of the tensor-parallel step."""
    n, i = mesh.size(axis), mesh.index(axis)
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"batch of {size} does not divide over {n} ranks")
    b = size // n
    return x.narrow(dim, i * b, b)


def hidden_rows(mesh: Mesh, h: torch.Tensor, axis: str = "dp") -> torch.Tensor:
    """This rank's block of an (L, B, H) state's batch."""
    return batch_columns(mesh, h, axis, dim=1)

