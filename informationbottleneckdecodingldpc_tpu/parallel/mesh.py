"""Mesh/sharding helpers for the Monte-Carlo engine.

The reference is single-device (one PyOpenCL queue, SURVEY.md §2.3); the
scale-out axis here is data parallelism over codewords and Monte-Carlo
blocks: one ``jax.sharding.Mesh`` over all chips, the codeword batch sharded
on axis ``'data'``, error/frame counters and the batch-global early-exit
syndrome test reduced with ``psum`` so every shard stays in lockstep exactly
like the reference's single in-order queue. On multi-host systems call
``jax.distributed.initialize()`` first; ``make_mesh`` then spans all
processes' devices.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec


DATA_AXIS = "data"


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> tuple[int, int]:
    """Join the multi-process JAX runtime (SURVEY.md §5 distributed backend).

    Wraps ``jax.distributed.initialize``: with no arguments the coordinator /
    process topology is taken from the cluster environment
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID). After
    this, ``jax.devices()`` spans every host's chips and :func:`make_mesh`
    builds a global data-parallel mesh; counters psum across every process's devices.

    Returns (process_index, process_count). Idempotent: a second call is a
    no-op (jax.distributed raises if already initialized).
    """
    import os

    import jax.distributed

    # Multi-process CPU (tests, local bring-up): the CPU client only joins
    # the cluster with a cross-process collectives implementation; without
    # it each process sees a 1-process backend. Gate on JAX_PLATFORMS (not
    # jax.default_backend(), which would initialize backends too early).
    if "cpu" in os.environ.get("JAX_PLATFORMS", "").split(","):
        jax.config.update("jax_cpu_collectives_implementation", "gloo")

    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:  # already initialized
        if "already" not in str(e).lower():
            raise
    return jax.process_index(), jax.process_count()


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D data-parallel mesh over the first ``n_devices`` devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    import numpy as np

    return Mesh(np.asarray(devices), (DATA_AXIS,))


def data_parallel_spec() -> PartitionSpec:
    return PartitionSpec(DATA_AXIS)


def psum_convergence_reduce(axis_name: str = DATA_AXIS):
    """Convergence reduction for decoders running under shard_map: global
    unconverged-codeword count across all shards (lockstep early exit)."""

    def reduce(u: jnp.ndarray) -> jnp.ndarray:
        return jax.lax.psum(jnp.sum(u.astype(jnp.int32)), axis_name)

    return reduce
