"""metabuli_tpu — a metagenomic taxonomic classification framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of Metabuli
(steineggerlab/Metabuli): classification of DNA sequencing reads against
reference-genome databases via 64-bit *metamers* (joint amino-acid + codon
k-mers), with database construction, taxonomy handling, abundance estimation
and reporting.

Architecture:
  - All per-base / per-k-mer compute (6-frame metamer extraction, syncmer
    selection, sorted-table lookup, Hamming scoring, match chaining) runs as
    vectorized XLA programs over fixed shapes on the accelerator.
  - The reference's sequential delta-decode merge-join
    (`/root/reference/src/commons/KmerMatcher.cpp:123-481`) is replaced by
    binary search + capped gather over a device-resident sorted metamer table.
  - Multi-device scaling shards the metamer table by amino-acid range over a
    `jax.sharding.Mesh` axis, and read batches over a data axis.
  - Host side (C++/Python) does IO, taxonomy, reporting and orchestration.

64-bit integer note: metamer values are 40-bit amino-acid part << 24 | 24-bit
codon part (`/root/reference/src/commons/Kmer.h:52-75`), so the package
requires jax_enable_x64, which is switched on at import.

The backend is JAX's own choice (``JAX_PLATFORMS`` selects it).
"""

import os as _os

import jax as _jax

_jax.config.update("jax_enable_x64", True)


def compile_cache_dir() -> str:
    """Where compiled programs persist between runs.

    ``JAX_COMPILATION_CACHE_DIR`` is JAX's own setting and wins when set;
    otherwise one fixed directory next to the package (``.jax_cache`` at
    the checkout root). A fixed path matters: the path is part of what a
    later run looks up, so a moving directory never hits."""
    env = _os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    return _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache")


if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

__version__ = "0.1.0"
