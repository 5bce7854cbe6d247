"""The port's device mesh: the counterpart of ``jax.sharding.Mesh`` and of
the ``lax`` collectives the time-sharding helpers use (parallel/time.py).

JAX runs one program over the devices of a mesh with ``shard_map``; one
process drives all of its local devices, and ``ppermute``, ``all_gather``
and ``psum`` cross processes when the mesh spans them.  PyTorch has no
such single-process SPMD, so a mesh here is a layout of tensors:

* A ``"time"`` axis of size D splits every chunk into D consecutive
  shards.  A process holds ``D / world`` of them, stacked on a LEADING
  axis of one tensor on its device: ``[D_local, ..., T / D]``.  On one
  card (no process group) a time mesh of D is ``[D, ..., T / D]``, the
  same computation as the JAX package's D virtual CPU devices in one
  process.  A value that is the same on every shard (a block's carried
  state, a ``psum``) has no such axis.
* A ``"channel"`` axis is the one-card channel bank: ``[C, ...]`` rows
  (core/runtime.py).
* With a ``torch.distributed`` process group, the processes split the
  mesh's FIRST axis into contiguous ranges, as a mesh built from
  process-ordered devices does in JAX: rank r owns indices
  ``[r n / world, (r + 1) n / world)`` of it.  Only boundary values cross
  processes: the k-sample halo between the last shard of one process and
  the first of the next, and the per-shard summaries of the distributed
  prefixes, each as one ``all_gather`` of the group.

Transport follows the group's backend (``torch.distributed.get_backend``),
never a caught error: NCCL (one rank per card) gathers device tensors
where they are; gloo takes CUDA tensors only for broadcast and
all_reduce, so under gloo a payload is staged through a host tensor.  The
payloads are halos and summaries, bytes rather than megabytes.  Every
reduction (``psum``, ``pmin``, ``pmax``) is an ``all_gather`` followed by
the same reduction on every process, so all processes hold bit-identical
results and carried state stays replicated.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _gather(v: torch.Tensor, group) -> torch.Tensor:
    """Concatenate ``v`` [k, ...] of every process of ``group`` in rank
    order along axis 0; under gloo through host tensors."""
    dev, dtype = v.device, v.dtype
    t = v.detach()
    if dist.get_backend(group) == "gloo" and t.is_cuda:
        t = t.cpu()
    if dtype == torch.bool:
        t = t.to(torch.uint8)
    if t.is_complex():
        t = torch.view_as_real(t)
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    out = torch.cat(parts, 0)
    if dtype.is_complex:
        out = torch.view_as_complex(out.contiguous())
    return out.to(device=dev, dtype=dtype)


def split_shards(v: torch.Tensor, n: int) -> torch.Tensor:
    """[..., n L] -> its n consecutive time shards stacked in front,
    [n, ..., L]."""
    return v.reshape(v.shape[:-1] + (n, v.shape[-1] // n)).movedim(-2, 0)


def join_shards(y):
    """The inverse of :func:`split_shards`, [n, ..., L] -> [..., n L]; a
    masked (values, mask) pair joins each."""
    if isinstance(y, tuple):
        return tuple(join_shards(t) for t in y)
    y = y.movedim(0, -2)
    return y.reshape(y.shape[:-2] + (y.shape[-2] * y.shape[-1],))


class Axis:
    """One mesh axis as the helpers see it inside a step: ``size`` shards
    in all, of which this process holds ``lo`` to ``hi`` (global indices),
    stacked on the leading axis of every sharded tensor.  ``group`` is the
    process group the axis spans, or None where it is all local."""

    def __init__(self, name: str, size: int, lo: int = 0,
                 hi: int | None = None, group=None):
        self.name = name
        self.size = int(size)
        self.lo = int(lo)
        self.hi = self.size if hi is None else int(hi)
        self.group = group
        self.n_local = self.hi - self.lo
        self.rank = dist.get_rank(group) if group is not None else 0
        self.world = dist.get_world_size(group) if group is not None else 1

    def __repr__(self):
        return (f"Axis({self.name!r}, size={self.size}, "
                f"local=[{self.lo}, {self.hi}))")

    def index(self, device=None) -> torch.Tensor:
        """Global index of each local shard, [n_local] int64 (JAX's
        ``lax.axis_index``, one per stacked shard)."""
        return torch.arange(self.lo, self.hi, device=device)

    def all_gather(self, v: torch.Tensor) -> torch.Tensor:
        """Per-shard values [n_local, ...] -> every shard's [size, ...]."""
        return v if self.group is None else _gather(v, self.group)

    def psum(self, v: torch.Tensor) -> torch.Tensor:
        return self.all_gather(v).sum(0)

    def pmin(self, v: torch.Tensor) -> torch.Tensor:
        return self.all_gather(v).amin(0)

    def pmax(self, v: torch.Tensor) -> torch.Tensor:
        return self.all_gather(v).amax(0)

    def last(self, v: torch.Tensor) -> torch.Tensor:
        """The value of the global last shard, [n_local, ...] -> [...]."""
        if self.group is None:
            return v[-1]
        return _gather(v[-1:], self.group)[-1]

    def _halo(self, x: torch.Tensor, k: int, ring: bool, first=None):
        """(halo [n_local, ..., k]: each shard's left neighbour's last k
        samples, global shard 0 taking ``first`` (broadcast; the carried
        state entering the stream), else zeros or, with ``ring``, the
        global tail; the global tail [..., k])."""
        tails = x[..., x.shape[-1] - k:]
        if self.group is None:
            before, tail = tails[-1:], tails[-1]
        else:
            ends = _gather(tails[-1:], self.group)      # [world, ..., k]
            r = self.rank
            before = ends[r - 1:r] if r else ends[-1:]
            tail = ends[-1]
        if self.lo == 0 and first is not None:
            before = torch.as_tensor(first, device=x.device).to(
                x.dtype).expand(tails.shape[1:])[None]
        elif self.lo == 0 and not ring:
            before = torch.zeros_like(tails[:1])
        if self.n_local == 1:
            return before, tail
        return torch.cat([before, tails[:-1]], 0), tail

    def left_halo(self, x: torch.Tensor, k: int, first=None) -> torch.Tensor:
        """The last k samples of each shard's LEFT neighbour; on shard 0
        ``first`` (JAX's ``where(axis_index == 0, tail, halo)``) or zeros
        (JAX's ppermute d -> d + 1)."""
        return self._halo(x, k, False, first)[0]

    def ring_halo(self, x: torch.Tensor, k: int) -> torch.Tensor:
        """The circular form: shard 0 receives the last shard's tail
        (JAX's ppermute d -> (d + 1) mod D)."""
        return self._halo(x, k, True)[0]

    def halo_and_tail(self, x: torch.Tensor, k: int, first=None):
        """(:meth:`left_halo`, the global tail [..., k] replicated) from
        one exchange: a tail-state block's intra-chunk halos and its next
        carried state at once."""
        return self._halo(x, k, False, first)

    def tail(self, x: torch.Tensor, k: int) -> torch.Tensor:
        """The stream's last k samples [..., k] (replicated)."""
        return self.last(x[..., x.shape[-1] - k:])

    def at_first(self, per_shard: torch.Tensor, value) -> torch.Tensor:
        """``per_shard`` with the entry of global shard 0 replaced by
        ``value`` (broadcast), where this process holds shard 0: the
        carried state enters the stream there."""
        if self.lo != 0:
            return per_shard
        v = torch.as_tensor(value, device=per_shard.device).to(
            per_shard.dtype).expand(per_shard.shape[1:])
        if per_shard.shape[0] == 1:
            return v[None]
        return torch.cat([v[None], per_shard[1:]], 0)


class Mesh:
    """Named axes and their sizes (``jax.sharding.Mesh(devices,
    axis_names)`` takes them from the shape of its device array), and the
    process group they span, if any.

    ``Mesh((4,), ("time",))`` is a time mesh of 4 shards on one card;
    ``Mesh((2, 4), ("channel", "time"))`` banks 2 channels with each
    stream in 4 time shards; with ``group=`` (parallel/multihost.py
    ``initialize``) the processes of the group split the first axis."""

    def __init__(self, shape, axis_names, group=None):
        shape = (shape,) if isinstance(shape, int) else tuple(
            int(s) for s in shape)
        axis_names = ((axis_names,) if isinstance(axis_names, str)
                      else tuple(axis_names))
        if len(shape) != len(axis_names) or not shape:
            raise ValueError(f"mesh shape {shape} does not match its axis "
                             f"names {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated mesh axis name in {axis_names}")
        if any(s < 1 for s in shape):
            raise ValueError(f"mesh axis sizes must be positive: {shape}")
        self.axis_names = axis_names
        #: axis name -> size, in axis order (JAX's ``Mesh.shape``)
        self.shape = dict(zip(axis_names, shape))
        self.group = group
        self.world = dist.get_world_size(group) if group is not None else 1
        self.rank = dist.get_rank(group) if group is not None else 0
        if shape[0] % self.world:
            raise ValueError(
                f"mesh: {self.world} processes cannot split its first axis "
                f"{axis_names[0]!r} of size {shape[0]} into equal "
                f"contiguous ranges; put the axis the processes span first")

    def __repr__(self):
        return (f"Mesh({tuple(self.shape.values())}, {self.axis_names}"
                f"{', world=%d' % self.world if self.world > 1 else ''})")

    @property
    def multihost(self) -> bool:
        """True when the mesh spans more than one process."""
        return self.world > 1

    def local_range(self, name: str) -> tuple[int, int]:
        """The indices [lo, hi) of axis ``name`` this process holds."""
        n = self.shape[name]
        if name != self.axis_names[0] or self.world == 1:
            return 0, n
        per = n // self.world
        return self.rank * per, (self.rank + 1) * per

    def axis(self, name: str) -> Axis:
        """The :class:`Axis` the helpers take for mesh axis ``name``."""
        lo, hi = self.local_range(name)
        spans = name == self.axis_names[0] and self.world > 1
        return Axis(name, self.shape[name], lo, hi,
                    self.group if spans else None)


__all__ = ["Mesh", "Axis", "split_shards", "join_shards"]
