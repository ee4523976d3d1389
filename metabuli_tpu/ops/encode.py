"""Vectorized 6-frame metamer extraction (device-side, XLA-friendly).

Replaces the reference's sequential per-base scanners
(`/root/reference/src/commons/KmerScanner.h:49-118`,
`/root/reference/src/commons/SyncmerScanner.h:9-103`) with fixed-shape
window computations over a whole batch of reads at once:

  * A read of length L covers ``usedLen = 3*((L-2)//3)`` bases
    (`/root/reference/src/commons/LocalUtil.h:51-59`), i.e. ``A = (L-2)//3``
    codons per reading frame.
  * Frame begins: forward frame f starts at base f; reverse frame f starts at
    ``(L%3 - (f-3)) mod 3`` and is scanned as the reverse complement
    (`/root/reference/src/commons/KmerExtractor.cpp:356-366`).
  * A metamer window of 8 codons at codon index p is emitted iff all 8 codons
    are valid (no N / out-of-range); its 64-bit value is
    ``(aaPart << 24) | dnaPart`` with 5-bit amino acids and 3-bit codon
    numbers, most significant first (`/root/reference/src/commons/Kmer.h:52-75`,
    `KmerScanner.h:82-117`).
  * Reported base positions: forward ``begin + 3p``, reverse
    ``seqEnd - 3(p+8) + 1`` (`KmerScanner.h:110-114`).
  * Closed-syncmer selection keeps a window iff the first occurrence of the
    minimum s-mer (5-bit packed amino acids, length s) over offsets
    ``0..8-s`` sits at offset 0 or ``8-s``
    (`/root/reference/src/commons/SyncmerScanner.h:36-102`).

Everything here runs under jit with static shapes; invalid windows are
reported via a validity mask instead of being compacted, so downstream ops
stay fixed-shape.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .genetic_code import codon_tables

K = 8  # metamer length in codons

# Reverse-complement of 3-bit base codes: A<->T (0<->2), C<->G (1<->3), else 7.
_RC8 = np.array([2, 3, 0, 1, 7, 7, 7, 7], dtype=np.uint8)


class Metamers(NamedTuple):
    """Fixed-shape extraction result: [B, 6, W] arrays."""

    value: jax.Array  # uint64 metamer values (garbage where ~valid)
    pos: jax.Array    # int32 base position (reference semantics)
    valid: jax.Array  # bool
    dna48: jax.Array  # uint64: 8 codons x 6 bits of raw 2-bit bases, same
                      # per-codon bit order as the value's codon numbers
                      # (codon at value-bits 3j sits at dna48-bits 6j)


def max_codons(max_len: int) -> int:
    """Codon capacity A for a padded batch of length ``max_len``."""
    return max(0, (max_len - 2) // 3)


def max_windows(max_len: int) -> int:
    return max(0, max_codons(max_len) - K + 1)


@functools.partial(
    jax.jit,
    static_argnames=("reduced", "syncmer", "smer_len", "kmer_format"),
)
def extract_metamers(
    codes: jax.Array,   # [B, L] uint8 base codes (0..3, 7 = N/invalid/pad)
    lens: jax.Array,    # [B] int32 true sequence lengths
    *,
    reduced: bool = False,
    syncmer: bool = False,
    smer_len: int = 5,
    kmer_format: int = 2,
) -> Metamers:
    """Extract metamers for all 6 reading frames of every read in the batch."""
    if kmer_format not in (1, 2):
        raise ValueError(f"unsupported kmer_format {kmer_format}")
    # Reduced 16-letter alphabet: 4-bit amino acids + 4-bit codon numbers,
    # AA part in bits 63..32 (`SeqIterator.cpp:29-43` bitsForCodon=4 /
    # bitsFor8Codons=32; masks `ReducedKmerMatcher.h:63-66`,
    # `IndexCreator.cpp:31-37`). Note the reference's *current* scanner
    # (`KmerScanner.h:82-117`) hardcodes the standard 5+3-bit packing and
    # would truncate reduced codon numbers (up to 10) to 3 bits — we
    # implement the coherent layout its matcher/taxonomer expect instead.
    B, L = codes.shape
    A = max_codons(L)
    W = max(0, A - K + 1)
    if W == 0:
        z = jnp.zeros((B, 6, 0))
        return Metamers(
            z.astype(jnp.uint64), z.astype(jnp.int32), z.astype(bool),
            z.astype(jnp.uint64),
        )

    aa_tab_np, num_tab_np = codon_tables(reduced)

    lens = lens.astype(jnp.int32)
    used_len = 3 * ((lens - 2) // 3)          # LocalUtil::getMaxCoveredLength
    used_len = jnp.maximum(used_len, 0)
    aa_len = used_len // 3                    # codons per frame, per read

    codon_idx = jnp.arange(A, dtype=jnp.int32)  # [A]

    # Gather-lean frame extraction: instead of per-frame per-codon base
    # gathers (18 dynamic gathers + 12 table lookups per batch),
    # everything funnels through ONE table lookup on packed base triples:
    #   trip[b, p]  = bases (p, p+1, p+2) packed to 6 bits (64 = invalid),
    #                 built from three STATIC shifted slices — no gather;
    #   combo[t]    = c6 | aa<<6 | num<<11 for the forward codon (bits
    #                 14..0) and for its reverse complement (bits 29..15),
    #                 aa=31 sentinel at t=64 marks invalid triples.
    # Every frame is then a static stride-3 slice of combo[trip]
    # (reverse frames select among the three slice classes by begin).
    _r = np.arange(64)
    # rc base = code ^ 2 (see _RC8); reverse codon reads the triple backwards
    _rc3 = ((((_r & 3) ^ 2) << 4) | ((((_r >> 2) & 3) ^ 2) << 2)
            | (((_r >> 4) & 3) ^ 2))
    _fwd = _r | (aa_tab_np << 6) | (num_tab_np << 11)
    _rev = _rc3 | (aa_tab_np[_rc3] << 6) | (num_tab_np[_rc3] << 11)
    _sent = 31 << 6
    combo_np = np.concatenate(
        [_fwd | (_rev << 15), [_sent | (_sent << 15)]]).astype(np.int32)

    ci32 = codes.astype(jnp.int32)
    trip = (ci32[:, : L - 2] << 4) | (ci32[:, 1 : L - 1] << 2) | ci32[:, 2:]
    trip_ok = (
        (ci32[:, : L - 2] < 4) & (ci32[:, 1 : L - 1] < 4) & (ci32[:, 2:] < 4)
    )
    # 64-way constant lookup as a binary select tree (6 rounds of where):
    # fused elementwise work over the [B, L-2] triple matrix instead of a
    # per-element gather
    trip_c = jnp.where(trip_ok, trip, 0)
    lvl = [jnp.int32(int(v)) for v in combo_np[:64]]
    for bit in range(6):
        sel = (trip_c >> bit) & 1
        lvl = [jnp.where(sel == 1, lvl[2 * i + 1], lvl[2 * i])
               for i in range(len(lvl) // 2)]
    z = jnp.where(trip_ok, lvl[0], jnp.int32(int(combo_np[64])))  # [B, L-2]
    zf = z & jnp.int32(0x7FFF)
    zr = z >> 15

    frame_aas = []
    frame_nums = []
    frame_c6 = []
    frame_ok = []
    frame_pos0 = []  # position of base 0 of codon p, per frame: pos = pos0 + 3p

    # Reverse frames are enumerated in ASCENDING genome order (codon k of
    # frame f>=3 sits at triple start begin + 3k), NOT the reference's
    # descending seqEnd-down order: the k-th codon then comes from a STATIC
    # stride-3 slice of zr selected by begin (three slices + two
    # elementwise selects), replacing a [B, A] take_along_axis gather per
    # frame. Window w' of the ascending enumeration is window
    # (aa_len - 8 - w') of the reference's (its VALUE packs codons
    # k = w'+7 .. w' — see the packing loop below — and its position is
    # begin + 3w'), so the frame emits exactly the
    # reference's (value, pos) multiset; only intra-frame enumeration order
    # differs, which the final (qid, species, frame, pos, ...) match sort
    # erases (`KmerExtractor.cpp:342-373` semantics preserved).
    zr_sl = []
    for c in range(3):
        s = zr[:, c::3][:, :A]
        if s.shape[1] < A:
            s = jnp.pad(s, ((0, 0), (0, A - s.shape[1])),
                        constant_values=_sent)
        zr_sl.append(s)
    for f in range(6):
        if f < 3:
            begin = jnp.full((B,), f, dtype=jnp.int32)
            v = zf[:, f::3][:, :A]
            if v.shape[1] < A:
                v = jnp.pad(v, ((0, 0), (0, A - v.shape[1])),
                            constant_values=_sent)
        else:
            begin = jnp.mod(lens % 3 - (f - 3), 3)
            b_ = begin[:, None]
            v = jnp.where(
                b_ == 0, zr_sl[0], jnp.where(b_ == 1, zr_sl[1], zr_sl[2])
            )
        aa_f = (v >> 6) & 31
        ok = (aa_f != 31) & (codon_idx[None, :] < aa_len[:, None])
        frame_aas.append(jnp.where(ok, aa_f, -1))
        frame_nums.append(jnp.where(ok, (v >> 11) & 15, 0))
        frame_c6.append(jnp.where(ok, v & 63, 0))
        frame_ok.append(ok)
        frame_pos0.append(begin)

    aa = jnp.stack(frame_aas, axis=1)     # [B, 6, A] int32, -1 invalid
    num = jnp.stack(frame_nums, axis=1)   # [B, 6, A] int32
    c6 = jnp.stack(frame_c6, axis=1)      # [B, 6, A] int32 raw codon bases
    ok = jnp.stack(frame_ok, axis=1)      # [B, 6, A] bool
    pos0 = jnp.stack(frame_pos0, axis=1)  # [B, 6] int32

    # Window validity and packed value via 8 static shifted slices.
    bits_codon = 4 if reduced else 3
    bits_aa = 4 if reduced else 5
    aa_shift = 32 if reduced else 24
    aa_mask_bits = 32 if reduced else 40
    # Reverse-frame windows pack their codons in DESCENDING genome order
    # while the frame arrays above are ascending. Expressing that as
    # per-step mirrored slices (concat of arr[:3, j:j+W] with
    # arr[3:, K-1-j:...]) MISCOMPILES on this XLA build (jit output
    # differs from op-by-op eager; see tests/test_encode.py's
    # jit-vs-eager gate), so the packing runs in FLIPPED coordinates
    # instead: flip the reverse frames' codon axis once, pack every frame
    # with the same uniform j-slices, and flip the reverse frames' window
    # axis back at the end — algebraically identical (window w' of the
    # ascending enumeration lands at flipped index W-1-w').
    def flip_rev(arr):
        return jnp.concatenate(
            [arr[:, :3], jnp.flip(arr[:, 3:], axis=-1)], axis=1)

    aa_flip = flip_rev(aa)
    aa_u = aa_flip.astype(jnp.uint64)
    num_u = flip_rev(num).astype(jnp.uint64)
    c6_u = flip_rev(c6).astype(jnp.uint64)
    ok_f = flip_rev(ok)
    aa_part = jnp.zeros(aa_u[..., :W].shape, jnp.uint64)
    dna_part = jnp.zeros_like(aa_part)
    dna48 = jnp.zeros_like(aa_part)
    valid = jnp.ones(aa_part.shape, bool)
    for j in range(K):
        aa_part = (aa_part << bits_aa) | aa_u[..., j : j + W]
        dna_part = (dna_part << bits_codon) | num_u[..., j : j + W]
        valid = valid & ok_f[..., j : j + W]
    if kmer_format == 2:
        for j in range(K):
            dna48 = (dna48 << 6) | c6_u[..., j : j + W]
        value = ((aa_part & ((jnp.uint64(1) << aa_mask_bits) - 1)) << aa_shift) | (
            dna_part & ((jnp.uint64(1) << aa_shift) - 1)
        )
    else:
        # Old format (`KmerScanner.h:120-182`): amino acids packed base-21
        # little-endian (aa of codon j weighted 21**j), codon numbers
        # little-endian 3-bit. dna48 mirrors the little-endian codon order.
        # Reduced mode historically used base-16 powers (`SeqIterator.cpp:39-42`),
        # which equals 4-bit little-endian fields.
        aa_base = 16 if reduced else 21
        aa_old = jnp.zeros(aa_part.shape, jnp.uint64)
        dna_old = jnp.zeros(aa_part.shape, jnp.uint64)
        for j in range(K):
            aa_old = aa_old + aa_u[..., j : j + W] * np.uint64(aa_base**j)
            dna_old = dna_old | (num_u[..., j : j + W] << (bits_codon * j))
            dna48 = dna48 | (c6_u[..., j : j + W] << (6 * j))
        value = ((aa_old & ((jnp.uint64(1) << aa_mask_bits) - 1)) << aa_shift) | (
            dna_old & ((jnp.uint64(1) << aa_shift) - 1)
        )

    if syncmer:
        # still in flipped window coordinates: the uniform-slice syncmer
        # scan is exact there (canonical s-mer order falls out of the flip)
        valid = valid & _syncmer_keep(aa_flip, smer_len, W)

    # back to ascending window order for the reverse frames
    value = flip_rev(value)
    dna48 = flip_rev(dna48)
    valid = flip_rev(valid)

    # Positions: pos0 + 3p for every frame (ascending reverse enumeration).
    p = jnp.arange(W, dtype=jnp.int32)
    pos = pos0[:, :, None] + 3 * p[None, None, :]

    return Metamers(
        value=value, pos=pos.astype(jnp.int32), valid=valid, dna48=dna48
    )


def _syncmer_keep(aa: jax.Array, smer_len: int, W: int) -> jax.Array:
    """Closed-syncmer mask over [B, 6, W] windows.

    Keeps window p iff the first occurrence of the minimal s-mer among offsets
    0..K-s is at offset 0 or K-s, matching the monotonic-deque scanner
    (`SyncmerScanner.h:56-73`: strictly-greater pops keep the earliest
    occurrence of the minimum at the deque front).

    ``aa`` must be in FLIPPED window coordinates for reverse frames (see
    extract_metamers): there the uniform slices below enumerate each
    window's s-mers in exactly the canonical (descending-genome) order the
    reference scans, so the argmin tie rule carries over unchanged.
    """
    s = smer_len
    n_smer = K - s + 1
    A = aa.shape[-1]
    n_smer_pos = A - s + 1
    aa_u = jnp.where(aa >= 0, aa, 0).astype(jnp.uint64)
    smer = jnp.zeros(aa_u[..., :n_smer_pos].shape, jnp.uint64)
    for j in range(s):
        smer = (smer << 5) | aa_u[..., j : j + n_smer_pos]
    # For each window p, s-mers at p..p+K-s. argmin gives first occurrence.
    stack = jnp.stack([smer[..., t : t + W] for t in range(n_smer)], axis=-1)
    first_min = jnp.argmin(stack, axis=-1)
    return (first_min == 0) | (first_min == n_smer - 1)


# ---------------------------------------------------------------- AA k-mers
# Amino-acid k-mer scanners for kmerFormat 3/4 (UniRef / read-group modules):
# `KmerScanner_aa2aa` (`KmerScanner.h:264-350`) over protein sequences and
# `KmerScanner_dna2aa` (`KmerScanner.h:185-261`) over 6-frame translations.

def _build_aa_char_table() -> np.ndarray:
    """Residue char -> code (`KmerScanner.h:272-306`); codes > 23 invalid."""
    tab = np.full(256, 27, np.uint8)
    for i, ch in enumerate("ARNDCQEGHILKMFPSTWYV"):
        tab[ord(ch)] = i
    tab[ord("B")] = 20
    tab[ord("Z")] = 21
    tab[ord("U")] = 22
    tab[ord("O")] = 23
    tab[ord("*")] = 24
    for ch in "-.?":
        tab[ord(ch)] = 25
    tab[ord("X")] = 26
    # lowercase maps like uppercase (kseq yields raw sequence; the reference
    # indexes the raw char, so keep lowercase invalid to match `aacids`)
    return tab


AA_CHAR_CODE = _build_aa_char_table()


def encode_aa_seqs_padded(seqs, max_len=None):
    lens = np.array([len(s) for s in seqs], dtype=np.int32)
    if max_len is None:
        max_len = int(lens.max()) if len(seqs) else 0
    out = np.full((len(seqs), max_len), 27, dtype=np.uint8)
    for i, s in enumerate(seqs):
        if isinstance(s, str):
            s = s.encode()
        n = min(len(s), max_len)
        out[i, :n] = AA_CHAR_CODE[np.frombuffer(s, dtype=np.uint8)[:n]]
    return out, lens


@functools.partial(jax.jit, static_argnames=("k", "syncmer", "smer_len"))
def extract_aa_kmers(
    codes: jax.Array,  # [B, L] uint8 residue codes
    lens: jax.Array,
    *,
    k: int = 12,
    syncmer: bool = False,
    smer_len: int = 5,
):
    """AA k-mers from protein sequences (KmerScanner_aa2aa semantics):
    5-bit packed, emitted at every window whose residues are all valid
    (code <= 23). Returns (values u64 [B, W], pos i32, valid bool)."""
    B, L = codes.shape
    W = max(0, L - k + 1)
    ok = codes <= 23
    aa_u = codes.astype(jnp.uint64)
    value = jnp.zeros((B, W), jnp.uint64)
    valid = jnp.ones((B, W), bool)
    for j in range(k):
        value = (value << 5) | aa_u[:, j : j + W]
        valid = valid & ok[:, j : j + W]
    pos = jnp.broadcast_to(jnp.arange(W, dtype=jnp.int32)[None, :], (B, W))
    valid = valid & (pos + k <= lens[:, None])
    if syncmer:
        n_smer_pos = L - smer_len + 1
        smer = jnp.zeros((B, n_smer_pos), jnp.uint64)
        for j in range(smer_len):
            smer = (smer << 5) | jnp.where(ok, aa_u, 0)[:, j : j + n_smer_pos]
        n_smer = k - smer_len + 1
        stack = jnp.stack([smer[:, t : t + W] for t in range(n_smer)], axis=-1)
        first_min = jnp.argmin(stack, axis=-1)
        valid = valid & ((first_min == 0) | (first_min == n_smer - 1))
    return value, pos, valid


@functools.partial(jax.jit, static_argnames=("k",))
def extract_aa_kmers_dna(
    codes: jax.Array,  # [B, L] uint8 base codes
    lens: jax.Array,
    *,
    k: int = 12,
):
    """AA k-mers from 6-frame translated DNA (KmerScanner_dna2aa semantics).
    Returns (values u64 [B, 6, W], pos i32, valid bool)."""
    mm_like = _translate_frames(codes, lens)
    aa, ok, pos0 = mm_like
    B = codes.shape[0]
    A = aa.shape[-1]
    W = max(0, A - k + 1)
    aa_u = jnp.where(aa >= 0, aa, 0).astype(jnp.uint64)
    value = jnp.zeros((B, 6, W), jnp.uint64)
    valid = jnp.ones((B, 6, W), bool)
    for j in range(k):
        value = (value << 5) | aa_u[..., j : j + W]
        valid = valid & ok[..., j : j + W]
    p = jnp.arange(W, dtype=jnp.int32)
    sign = jnp.array([1, 1, 1, -1, -1, -1], dtype=jnp.int32)
    # reverse pos = seqEnd - (p + k)*3 + 1; pos0 already encodes the k=8
    # variant, so recompute from first principles here
    fwd_pos = pos0[:, :3, None] + 3 * p[None, None, :]
    # pos0 for reverse frames stored seqEnd - 3(K8-1) - 2; recover seqEnd
    seq_end = pos0[:, 3:, None] + 3 * (K - 1) + 2
    rev_pos = seq_end - 3 * (p[None, None, :] + k) + 1
    pos = jnp.concatenate([fwd_pos, rev_pos], axis=1)
    return value, pos.astype(jnp.int32), valid


def _translate_frames(codes: jax.Array, lens: jax.Array):
    """Shared 6-frame translation: returns (aa [B,6,A], ok, pos0 [B,6])."""
    from .genetic_code import codon_tables

    B, L = codes.shape
    A = max_codons(L)
    aa_tab = jnp.asarray(codon_tables(False)[0])
    rc_tab = jnp.asarray(_RC8)
    lens = lens.astype(jnp.int32)
    used_len = jnp.maximum(3 * ((lens - 2) // 3), 0)
    aa_len = used_len // 3
    codon_idx = jnp.arange(A, dtype=jnp.int32)

    def gather_codes(base_idx):
        safe = jnp.clip(base_idx, 0, L - 1)
        vals = jnp.take_along_axis(codes, safe.astype(jnp.int32), axis=1)
        return jnp.where((base_idx >= 0) & (base_idx < L), vals, jnp.uint8(7))

    aas, oks, pos0s = [], [], []
    for f in range(6):
        if f < 3:
            begin = jnp.full((B,), f, dtype=jnp.int32)
            b1 = begin[:, None] + 3 * codon_idx[None, :]
            c1, c2, c3 = gather_codes(b1), gather_codes(b1 + 1), gather_codes(b1 + 2)
        else:
            begin = jnp.mod(lens % 3 - (f - 3), 3)
            end = begin + used_len - 1
            b1 = end[:, None] - 3 * codon_idx[None, :]
            c1 = rc_tab[gather_codes(b1)]
            c2 = rc_tab[gather_codes(b1 - 1)]
            c3 = rc_tab[gather_codes(b1 - 2)]
        ok = (c1 < 4) & (c2 < 4) & (c3 < 4) & (codon_idx[None, :] < aa_len[:, None])
        ci = (c1.astype(jnp.int32) * 16 + c2.astype(jnp.int32) * 4
              + c3.astype(jnp.int32)) & 63
        aas.append(jnp.where(ok, aa_tab[ci], -1))
        oks.append(ok)
        pos0s.append(begin if f < 3 else (begin + used_len - 1) - 3 * (K - 1) - 2)
    return (jnp.stack(aas, 1), jnp.stack(oks, 1), jnp.stack(pos0s, 1))
