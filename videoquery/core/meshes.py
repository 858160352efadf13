"""Device mesh and sharding helpers.

The reference scales by share-nothing multiprocessing over GPUs
(calcSig_wOF.py:44-56,204-210; build_wof_clips.py:175-184) plus an unused
MPI Caffe build (features_GPU_compute/Dockerfile:37-53). Here the
equivalent is a single SPMD program over a jax.sharding.Mesh:

- axis "data"  — clips / index rows (data parallelism; also how the
  1M-segment index is sharded for search).
- axis "model" — the 6-member (stream, split) ensemble and, if a larger
  backbone is used, tensor parallelism.

Collectives (psum of ensemble averages, all-gather of per-shard top-k)
are inserted by XLA from the shardings and run as NCCL collectives over
NVLink. Every card of a host reaches every other at the same rate, so the
mesh shape follows the algorithm alone (a plain reshape of the device
list).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(devices=None, model_parallel: int = 1,
              axis_names: tuple[str, str] = (DATA_AXIS, MODEL_AXIS)) -> Mesh:
    """Build a 2-D (data, model) mesh over the given (or all) devices."""
    if devices is None:
        devices = jax.devices()
    devices = np.asarray(devices)
    n = devices.size
    if n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    grid = devices.reshape(n // model_parallel, model_parallel)
    return Mesh(grid, axis_names)


def data_sharding(mesh: Mesh, ndim: int, data_dim: int = 0) -> NamedSharding:
    """Shard dimension `data_dim` of an ndim-array over the data axis."""
    spec = [None] * ndim
    spec[data_dim] = DATA_AXIS
    return NamedSharding(mesh, P(*spec))


def model_sharding(mesh: Mesh, ndim: int, model_dim: int = 0) -> NamedSharding:
    spec = [None] * ndim
    spec[model_dim] = MODEL_AXIS
    return NamedSharding(mesh, P(*spec))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_multiple(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None) -> None:
    """Multi-process bring-up: jax.distributed — the replacement for the
    reference's (unused) MPI Caffe build
    (features_GPU_compute/Dockerfile:37-53; SURVEY.md §5.8). Nothing
    detects a GPU cluster automatically: pass coordinator_address
    ("host:port" of process 0), num_processes and process_id."""
    import jax

    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)
