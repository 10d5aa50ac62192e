"""Multi-host initialization (jax.distributed) and topology helpers.

The reference has zero networking (SURVEY.md §5 "Distributed communication
backend: none"); this is the BASELINE-mandated multi-host path: single-
controller JAX, one process per host, scene replicated, rays sharded over
all devices of all hosts, gradients psum-reduced across them
(parallel/sharding.py). This module owns process bootstrap and mesh
construction; it is a thin, testable wrapper so every entry point (bench,
fit CLI) initializes identically.

Typical launch (2 hosts):
    JAX_COORDINATOR=host0:1234 NPROC=2 PROC_ID=<0|1> python -m ... &
"""
from __future__ import annotations

import os
from typing import Optional

import jax

from .sharding import RAY_AXIS, make_mesh

_initialized = False


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> bool:
    """Initialize jax.distributed from args or environment; idempotent.

    Environment: ``JAX_COORDINATOR`` (host:port), ``NPROC``, ``PROC_ID`` —
    or any scheduler env jax.distributed auto-detects (GKE/Slurm). Returns
    True when multi-process mode is active, False for single-process (the
    no-op path every unit test takes).
    """
    global _initialized
    if _initialized:
        return jax.process_count() > 1
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR")
    num_processes = num_processes or int(os.environ.get("NPROC", "0")) or None
    process_id = (process_id if process_id is not None
                  else int(os.environ.get("PROC_ID", "-1")))
    if coordinator and num_processes and process_id >= 0:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)
        _initialized = True
        return True
    _initialized = True
    return False


def global_mesh():
    """1-D ray mesh over every device of every host (flat —
    legal because rays never communicate; only the psum crosses hosts)."""
    return make_mesh(jax.devices())


def topology_summary() -> dict:
    """Host/chip topology for logs and the scaling report."""
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
        "platform": jax.devices()[0].platform,
        "ray_axis": RAY_AXIS,
    }
