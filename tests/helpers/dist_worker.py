import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); coord = sys.argv[3]
jax.distributed.initialize(coordinator_address=coord, num_processes=nproc, process_id=pid)
import numpy as np
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
from metabuli_tpu.parallel import distributed as dist
from metabuli_tpu.parallel.mesh import build_sharded_classify, merge_shard_matches

print(f"proc {pid}: local={jax.local_device_count()} global={jax.device_count()}", flush=True)
mesh = dist.global_mesh(n_db=2)
rng = np.random.default_rng(0)
n = 4096
aa = np.sort(rng.choice(1 << 28, size=n, replace=False).astype(np.uint64))
values = np.sort((aa << np.uint64(24)) | rng.integers(0, 1 << 24, n).astype(np.uint64))
taxids = rng.integers(1, 64, n).astype(np.int32)
t2s = (np.arange(64, dtype=np.int32) % 16) + 1
db_arrays = dist.distribute_index(values, taxids, mesh)
*db_global, n_pad, iters = db_arrays
B = 8
codes = rng.integers(0, 4, size=(B, 120)).astype(np.uint8)
lens = np.full(B, 120, np.int32)
reads = dist.distribute_reads(codes, lens, np.zeros(B, np.int32), np.arange(B, dtype=np.int32), mesh)
step = build_sharded_classify(mesh, n_pad=n_pad, search_iters=iters, cap=8, max_matches=4096)
out = step(*db_global, t2s, *reads)
jax.block_until_ready(out)
local = [np.asarray(x.addressable_shards[0].data) for x in out]
print(f"proc {pid}: OK data shape {local[0].shape}", flush=True)
