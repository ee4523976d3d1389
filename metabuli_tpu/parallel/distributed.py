"""Multi-host execution (jax.distributed) for multi-device classification.

The reference is single-node (`SURVEY.md` §2.8); this provides the
scale-out path: every host joins a `jax.distributed` runtime, the global
(data, db) mesh spans all hosts' devices, each host feeds its own slice of
the read stream (data axis) and holds its assigned AA-range chunks of the
metamer table (db axis). Collectives run between the devices; the hosts
only carry read distribution and result gathering.

Usage (per host):

    from metabuli_tpu.parallel import distributed as dist
    dist.initialize(coordinator="host0:1234", num_processes=N, process_id=i)
    mesh = dist.global_mesh(n_db=...)
    step = build_sharded_classify(mesh, ...)
    arrays = dist.host_local_index_shards(values, taxids, mesh)
    ...

Single-process invocation degrades to the local mesh path.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import shard_index_aa_aligned


def initialize(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
):
    """Join (or no-op for single-process) the jax.distributed runtime."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(n_db: int | None = None) -> Mesh:
    """(data, db) mesh over all global devices (all hosts)."""
    devices = jax.devices()
    n = len(devices)
    if n_db is None:
        n_db = 2 if n % 2 == 0 and n >= 4 else 1
    arr = np.array(devices).reshape(n // n_db, n_db)
    return Mesh(arr, ("data", "db"))


def distribute_index(values: np.ndarray, taxids: np.ndarray, mesh: Mesh,
                     kmer_format: int = 2):
    """Build the AA-aligned shard arrays and place them on the mesh's db
    axis as global arrays. Every process must call this with the same
    (values, taxids); for DBs too large for one host, substitute per-host
    range loading keyed on `jax.process_index()` before the device_put."""
    n_db = mesh.shape["db"]
    db, n_pad, iters = shard_index_aa_aligned(values, taxids, n_db,
                                              kmer_format)
    db_sharding = NamedSharding(mesh, P("db", None))
    db_dev = tuple(jax.device_put(a, db_sharding) for a in db)
    return db_dev, n_pad, iters


def distribute_reads(codes, lens, pos_offsets, qid_offsets, mesh: Mesh):
    """Place a read batch on the data axis."""
    data_sharding = NamedSharding(mesh, P("data"))
    data2 = NamedSharding(mesh, P("data", None))
    return (
        jax.device_put(codes, data2),
        jax.device_put(lens, data_sharding),
        jax.device_put(pos_offsets, data_sharding),
        jax.device_put(qid_offsets, data_sharding),
    )
