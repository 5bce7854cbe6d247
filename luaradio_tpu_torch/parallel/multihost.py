"""Multi-process execution: one process per host (or per card), all running
the same flow graph over one mesh (the JAX package's
parallel/multihost.py, on ``torch.distributed``).

The reference's only distribution mechanism is one OS process per block
wired by UNIX socketpairs on one machine
(radio/core/composite.lua:568-636).  Here every process runs the SAME
graph and the mesh spans the processes (parallel/mesh.py): they split
its first axis into contiguous ranges.

Ingest follows the JAX package's pattern: every process reads the full
input stream from its own copy of the source and keeps only the block it
owns, so only the owned samples cross its host-to-device link.  Egress
is the mirror image: each process's sinks receive that process's
contiguous block of every chunk (per-process output sharding).  Across a
time split only halos and per-shard summaries cross processes
(torch.distributed all_gather; under gloo staged through host tensors,
parallel/mesh.py).

Nothing here has to build global arrays: the JAX package's ``from_local``
and ``replicate`` commit host data into process-spanning jax.Arrays,
which the port does not have (each process holds its own block, and a
device-resident ring is decoded by each process from its own copy of the
file).  The Runner integration lives in core/runtime.py.
"""

from __future__ import annotations

import torch.distributed as dist


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, backend: str = "gloo"):
    """Join the process group and return it.  ``coordinator_address`` is
    ``"host:port"`` (as the JAX package's) or an init URL
    (``"tcp://host:port"``, ``"file:///path"`` for a rendezvous through
    a shared file).  ``backend`` "gloo" runs on the CPU and on any number
    of processes per card (its device payloads go through host tensors);
    "nccl" needs one card per process."""
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)
    return dist.group.WORLD


def is_multihost(mesh) -> bool:
    """True when ``mesh`` spans more than one process."""
    return mesh is not None and mesh.multihost


def local_slices(mesh, shape, axes) -> tuple:
    """This process's contiguous block of a global array of ``shape``
    whose dimension i is split over mesh axis ``axes[i]`` (None: not
    split), as one slice per dimension."""
    out = []
    for n, name in zip(shape, axes):
        if name is None:
            out.append(slice(0, n))
            continue
        lo, hi = mesh.local_range(name)
        per = n // mesh.shape[name]
        out.append(slice(lo * per, hi * per))
    return tuple(out)


def local_block(mesh, arr, axes):
    """(this process's block of the global array ``arr``, the global
    index its LAST axis starts at), for translating global valid-sample
    counts to local ones."""
    sls = local_slices(mesh, arr.shape, axes)
    return arr[sls], sls[-1].start


__all__ = ["initialize", "is_multihost", "local_slices", "local_block"]
