"""Device mesh construction + multi-host initialization.

The replacement for the reference's mutex/queue thread fabric
(SURVEY.md §2.5, §5.8): collectives over a named mesh.  Two shapes are
supported:

  * 1-D ``("shard",)`` — the devices of one host (every GPU reaches
    every other at the same rate, so the mesh follows the algorithm
    alone).
  * 2-D ``("host", "chip")`` — several processes: the point axis is
    sharded over BOTH axes (host-major, so the anchor-block trajectory
    partition puts contiguous blocks on each host and the chip axis
    subdivides them); XLA splits psums over ``("host", "chip")`` into
    a reduction per host and a small [K,6]-sized one across hosts.

With several processes call :func:`initialize_distributed` before any
jax use; in one process (or on a virtual
``--xla_force_host_platform_device_count`` CPU mesh) it is a no-op and
the same mesh shapes compile unchanged.
"""

import os

import jax
import numpy as np
from jax.sharding import Mesh


def initialize_distributed(coordinator: str = None,
                           num_processes: int = None,
                           process_id: int = None) -> bool:
    """``jax.distributed.initialize`` with environment-based defaults.

    Reads ``JAX_COORDINATOR / JAX_NUM_PROCESSES / JAX_PROCESS_ID`` when
    args are None; silently no-ops single-process (the common dev /
    virtual-mesh case).  Returns True if a multi-process runtime was
    initialized.
    """
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR")
    n = num_processes or int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if not coordinator or n <= 1:
        return False
    pid = process_id if process_id is not None else int(
        os.environ.get("JAX_PROCESS_ID", "0"))
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=n, process_id=pid)
    return True


def make_mesh(n_devices: int = None, axis: str = "shard") -> Mesh:
    """1-D mesh over the first n_devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def make_host_chip_mesh(n_hosts: int = None, n_chips: int = None) -> Mesh:
    """2-D ``("host", "chip")`` mesh.

    Defaults: n_hosts = jax.process_count() (the processes that really
    exist), n_chips = devices per host.  Pass ``n_hosts`` to split one
    process's devices into several groups.  Device order is
    host-major, matching the anchor-block partition's host-contiguity
    expectation.
    """
    devs = jax.devices()
    if n_hosts is None:
        n_hosts = jax.process_count()
    if n_chips is None:
        n_chips = len(devs) // n_hosts
    devs = devs[:n_hosts * n_chips]
    grid = np.array(devs).reshape(n_hosts, n_chips)
    return Mesh(grid, ("host", "chip"))
