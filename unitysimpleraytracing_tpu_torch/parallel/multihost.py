"""Multi-host setup: process-group initialisation and a host-aware mesh.

Counterpart of ``unitysimpleraytracing_tpu/parallel/multihost.py`` on
``torch.distributed``: the same `parallel/dist` engines run across hosts,
the collectives of a host's ranks on its own interconnect (NVLink under NCCL)
and the cross-host legs on the network.

Layout policy: the ``tp`` (Morton-range) axis is placed along the ranks WITHIN
a host first and ``dp`` spans hosts, so the ring's and the shuffle's exchanges
stay inside a host while only the ray-batch split crosses hosts (put the
chatty axis on the fast interconnect).

Single-process environments skip initialisation (`initialize` returns False),
and `dist.make_mesh(1, 1)` starts a one-process group itself, so every code
path stays runnable on one device.
"""
from __future__ import annotations

import os
from datetime import timedelta

import torch.distributed as tdist

from unitysimpleraytracing_tpu_torch.parallel.dist import Mesh, make_mesh, mesh_device


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    device=None,
    timeout: timedelta | None = None,
) -> bool:
    """Initialise the default process group if a multi-process environment
    is configured: True if a group of more than one process is up, False for
    a single process.

    With a ``coordinator_address`` ("host:port") the group meets there
    (``tcp://``), of ``num_processes`` ranks, this one ``process_id``.
    Without one, torchrun's environment is used (``env://``: ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); no ``WORLD_SIZE`` above 1
    means a single process.  ``backend`` defaults to NCCL for a card and
    gloo for the CPU (`dist.mesh_device(device)`); several ranks sharing one
    card need ``backend="gloo"``, since NCCL refuses two ranks on one GPU.
    An already initialised group is kept.  ``timeout`` bounds every
    collective of the group (torch's default without it)."""
    if num_processes is not None and num_processes <= 1:
        return False
    if tdist.is_initialized():
        return tdist.get_world_size() > 1
    if coordinator_address is None:
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            return False
        init_method = "env://"
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and process_id")
        init_method = f"tcp://{coordinator_address}"
    if backend is None:
        backend = "nccl" if mesh_device(device).type == "cuda" else "gloo"
    kwargs = {} if timeout is None else {"timeout": timeout}
    tdist.init_process_group(backend, init_method=init_method, world_size=num_processes or -1,
                             rank=-1 if process_id is None else process_id, **kwargs)
    return tdist.get_world_size() > 1


def make_host_mesh(tp_per_host: int | None = None, device=None) -> Mesh:
    """(dp, tp) mesh with tp packed inside each host and dp spanning hosts.

    ``tp_per_host=None`` takes the ranks of one host for tp
    (``LOCAL_WORLD_SIZE``, which torchrun sets; 1 without it), so dp is the
    number of hosts; otherwise tp = ``tp_per_host`` and dp absorbs the rest.
    torchrun numbers the ranks of a host contiguously, so the (dp, tp)
    reshape with tp minor keeps each tp row within one host."""
    n = tdist.get_world_size() if tdist.is_initialized() else 1
    tp = int(os.environ.get("LOCAL_WORLD_SIZE", "1")) if tp_per_host is None else tp_per_host
    if n % tp:
        raise ValueError(f"{n} ranks not divisible by tp={tp}")
    return make_mesh(n // tp, tp, device)


def host_shard_bounds(n_items: int, num_hosts: int, host_id: int) -> tuple[int, int]:
    """Contiguous [lo, hi) range of items owned by ``host_id`` (per-host
    scene ingest: each host loads only its range of triangles)."""
    per = -(-n_items // num_hosts)
    lo = min(host_id * per, n_items)
    return lo, min(lo + per, n_items)
