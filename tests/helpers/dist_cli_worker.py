"""Worker for the 2-process distributed CLI classify test."""
import os, sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax

jax.config.update("jax_enable_compilation_cache", False)
pid, nproc, coord, q, db, out = sys.argv[1:7]
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
from metabuli_tpu import cli

rc = cli.main([
    "classify", q, db, out, "dj", "--seq-mode", "1", "--batch-reads", "16",
    "--coordinator", coord, "--num-processes", nproc, "--process-id", pid,
    "--db-shards", "2",
])
print(f"proc {pid}: rc={rc}", flush=True)
sys.exit(rc)
