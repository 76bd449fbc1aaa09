"""Device mesh construction — the framework's NCCL-equivalent layer.

The reference has no distributed backend at all (single Theano/TF device;
SURVEY.md §2c). Here the communication layer IS the mesh + XLA collectives
(NCCL on GPUs): axis "data" carries utterance-batch data parallelism, axis
"model" carries tensor sharding of quaternion weights (SURVEY.md §2c
P1/P2/P6, BASELINE.json north star). Multi-host bring-up goes through
`jax.distributed.initialize` before mesh construction; after that, 1 card and
N hosts differ only in the device list handed to the mesh.

Explicit NON-GOALS (SURVEY.md §2c P4/P5, documented as required):

* **Pipeline parallelism** — every model family here is tens of M params at
  most (the Hamilton product cuts per-layer weights 4x on top of that); even
  the librispeech_large encoder fits chips with DP+TP alone, so PP's bubble
  overhead and schedule complexity buy nothing. The two-axis mesh keeps the
  door open: a "stage" axis would slot in beside "data"/"model" if a future
  config needed it.
* **Expert/MoE parallelism, ring attention, Ulysses** — no reference config
  contains experts or attention of any kind (conv/dense/LSTM only); revisit
  only if a hybrid config grows an attention encoder.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(
    n_data: int = -1,
    n_model: int = 1,
    *,
    devices=None,
) -> Mesh:
    """Build a ("data", "model") mesh.

    n_data == -1 means "all remaining devices". Device order follows
    jax.devices(). The cards of one host are joined all to all by NVLink,
    so every pair is equally close and the mesh shape follows the algorithm
    alone.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if n_data == -1:
        if n % n_model:
            raise ValueError(f"{n} devices not divisible by n_model={n_model}")
        n_data = n // n_model
    if n_data * n_model != n:
        raise ValueError(f"mesh {n_data}x{n_model} != {n} devices")
    arr = np.asarray(devices).reshape(n_data, n_model)
    return Mesh(arr, (DATA_AXIS, MODEL_AXIS))


def initialize_multihost(
    coordinator: str | None = None,
    *,
    num_processes: int | None = None,
    process_id: int | None = None,
):
    """Multi-process bootstrap (no-op on a single process).

    Pass ``num_processes``/``process_id`` explicitly where no cluster
    environment supplies them (e.g. the 2-process CPU parity test in
    tests/test_multihost.py).
    """
    # check `coordinator` first: jax.process_count() initializes the XLA
    # backend, after which jax.distributed.initialize() refuses to run
    if coordinator or jax.process_count() > 1:
        kwargs = {}
        if num_processes is not None:
            kwargs["num_processes"] = num_processes
        if process_id is not None:
            kwargs["process_id"] = process_id
        jax.distributed.initialize(coordinator_address=coordinator, **kwargs)


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (batch) dim over the data axis."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
