"""Sorted-table metamer matching: binary search + capped gather.

Data-parallel replacement for the reference's sequential merge-join over the
delta-compressed k-mer stream (`/root/reference/src/commons/KmerMatcher.cpp:123-481`).
The database lives in device memory as a *decompressed* sorted ``uint64`` metamer array
plus a parallel taxid array; for every query metamer we:

  1. binary-search the range of database entries whose 40-bit amino-acid part
     equals the query's (equal-AA candidate set, `KmerMatcher.cpp:362-406`);
  2. gather up to ``cap`` candidates (fixed fan-out; ``cap`` is chosen from
     the database's largest AA-group so nothing is ever silently dropped);
  3. keep candidates whose DNA-level Hamming sum is
     ``<= min(2*min_distance, 7)`` (`KmerMatcher.cpp:1117-1146`);
  4. emit fixed-shape match tensors (mask + taxid/species/dna/hamming data),
     the analogue of the reference's 24-byte ``Match`` records
     (`/root/reference/src/commons/Match.h:9-26`).

Species IDs are resolved on device through a dense internal-taxid -> species
table (the reference's ``taxId2speciesId`` map, `KmerMatcher.cpp:56-120`,
made dense by the internal-ID remapping of TaxonomyWrapper).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .hamming import hamming_all, hamming_all_reduced

DNA_MASK24 = (1 << 24) - 1
DNA_MASK32 = (1 << 32) - 1


class MatchResult(NamedTuple):
    """[Q, cap] match tensors; ``keep`` marks real matches."""

    keep: jax.Array        # bool
    taxid: jax.Array       # uint32 target taxid (redundancy bit cleared)
    species: jax.Array     # uint32 target species taxid
    dna: jax.Array         # int32 target 24-bit DNA encoding
    hamming16: jax.Array   # int32 packed per-codon 2-bit distances
    hamming_sum: jax.Array # int32 total distance
    n_candidates: jax.Array  # [Q] int32 true AA-group size (overflow check)


@functools.partial(jax.jit, static_argnames=("cap", "reduced"))
def match_metamers(
    db_values: jax.Array,    # [N] uint64 sorted metamer values
    db_taxids: jax.Array,    # [N] uint32 per-entry taxid (internal IDs)
    tax2species: jax.Array,  # [T] uint32 dense internal-taxid -> species
    q_values: jax.Array,     # [Q] uint64 query metamers
    q_frames: jax.Array,     # [Q] int32 frame 0..5
    q_valid: jax.Array,      # [Q] bool
    *,
    cap: int,
    reduced: bool = False,
) -> MatchResult:
    n = db_values.shape[0]
    dna_mask = DNA_MASK32 if reduced else DNA_MASK24
    aa_mask = jnp.uint64(0xFFFFFFFFFFFFFFFF ^ dna_mask)
    q_aa = q_values & aa_mask
    # Invalid queries get an AA that can never match (all ones).
    q_aa = jnp.where(q_valid, q_aa, jnp.uint64(0xFFFFFFFFFFFFFFFF))

    lo = jnp.searchsorted(db_values, q_aa, side="left")
    hi = jnp.searchsorted(db_values, q_aa | jnp.uint64(dna_mask), side="right")
    n_cand = (hi - lo).astype(jnp.int32)

    idx = lo[:, None] + jnp.arange(cap, dtype=lo.dtype)[None, :]
    cand_ok = idx < hi[:, None]
    idx = jnp.minimum(idx, n - 1)
    t_val = db_values[idx]
    t_tax = db_taxids[idx]
    # bit-cast through uint32 keeps the 32-bit reduced DNA part intact
    t_dna = (t_val & jnp.uint64(dna_mask)).astype(jnp.uint32).view(jnp.int32)
    q_dna = (q_values & jnp.uint64(dna_mask)).astype(jnp.uint32).view(jnp.int32)

    ham_fn = hamming_all_reduced if reduced else hamming_all
    hsum, h_fwd, h_rev = ham_fn(q_dna[:, None], t_dna)
    hsum = jnp.where(cand_ok, hsum, jnp.int32(255))
    min_h = jnp.min(hsum, axis=1)
    cutoff = jnp.minimum(min_h * 2, 7)
    keep = cand_ok & (hsum <= cutoff[:, None])

    # Forward frames of the new format use the forward packing, reverse frames
    # the reversed packing (`KmerMatcher.cpp:1140-1142` with kmerFormat == 2).
    fwd_frame = (q_frames < 3)[:, None]
    h16 = jnp.where(fwd_frame, h_fwd, h_rev)

    species = tax2species[t_tax]
    return MatchResult(
        keep=keep,
        taxid=t_tax,
        species=species,
        dna=t_dna,
        hamming16=h16,
        hamming_sum=hsum,
        n_candidates=n_cand,
    )


@functools.partial(jax.jit, static_argnames=("kmer_format",))
def match_metamers_old_frames(q_frames: jax.Array, kmer_format: int) -> jax.Array:
    """Frame-direction selector for other k-mer formats.

    `KmerMatcher.cpp:1140`: forward packing iff ``not ((frame < 3) ^
    (kmerFormat == 2))`` — for the old format (1) *reverse* frames use the
    forward packing.
    """
    if kmer_format == 2:
        return q_frames < 3
    return q_frames >= 3


def sort_matches(qid, species, frame, pos, hamming, dna, taxid, hamming16, keep):
    """Device sort in the reference's match order (`KmerMatcher.cpp:1149-1166`):
    (qid, species, frame, pos, hamming_sum, dnaEncoding), with discarded
    matches pushed to the end (via leading ~keep key)."""
    not_keep = (~keep).astype(jnp.int32)
    keys = (not_keep, qid, species, frame, pos, hamming, dna)
    sorted_ops = jax.lax.sort(
        keys + (taxid, hamming16, keep), num_keys=len(keys)
    )
    (_, s_qid, s_sp, s_frame, s_pos, s_ham, s_dna, s_tax, s_h16, s_keep) = sorted_ops
    return s_qid, s_sp, s_frame, s_pos, s_ham, s_dna, s_tax, s_h16, s_keep
