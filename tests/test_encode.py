"""Vectorized extraction vs scalar reference state machines."""

import numpy as np
import pytest

from metabuli_tpu.ops import encode
from metabuli_tpu.ops.genetic_code import encode_seqs_padded

import ref_impl


def _device_kmers(seqs, **kw):
    codes, lens = encode_seqs_padded([s for s in seqs])
    mm = encode.extract_metamers(codes, lens, **kw)
    value = np.asarray(mm.value)
    pos = np.asarray(mm.pos)
    valid = np.asarray(mm.valid)
    out = []
    for b in range(len(seqs)):
        kmers = []
        for f in range(6):
            for w in range(value.shape[2]):
                if valid[b, f, w]:
                    kmers.append((int(value[b, f, w]), int(pos[b, f, w]), f))
        out.append(kmers)
    return out


def _ref_kmers(seq, **kw):
    return ref_impl.extract_all_frames(seq, **kw)


@pytest.mark.parametrize("length", [24, 25, 26, 30, 47, 100, 151, 302])
def test_metamers_match_reference(length):
    rng = np.random.default_rng(length)
    seqs = [ref_impl.random_dna(rng, length, n_prob=0.03) for _ in range(8)]
    dev = _device_kmers(seqs)
    for seq, got in zip(seqs, dev):
        want = _ref_kmers(seq)
        assert sorted(got) == sorted(want), f"len={length}"


def test_metamers_no_n():
    rng = np.random.default_rng(7)
    seqs = [ref_impl.random_dna(rng, 150, n_prob=0.0) for _ in range(16)]
    dev = _device_kmers(seqs)
    for seq, got in zip(seqs, dev):
        want = _ref_kmers(seq)
        assert sorted(got) == sorted(want)
        # no Ns: every frame emits aaLen-7 kmers
        used = ref_impl.max_covered_length(len(seq))
        assert len(got) == 6 * (used // 3 - 7)


def test_metamers_heavy_n():
    rng = np.random.default_rng(11)
    seqs = [ref_impl.random_dna(rng, 200, n_prob=0.15) for _ in range(8)]
    dev = _device_kmers(seqs)
    for seq, got in zip(seqs, dev):
        assert sorted(got) == sorted(_ref_kmers(seq))


def test_metamers_mixed_lengths_in_batch():
    rng = np.random.default_rng(5)
    lengths = [24, 37, 80, 150, 151, 152, 33, 61]
    seqs = [ref_impl.random_dna(rng, L, n_prob=0.02) for L in lengths]
    dev = _device_kmers(seqs)
    for seq, got in zip(seqs, dev):
        assert sorted(got) == sorted(_ref_kmers(seq))


def test_short_sequences_emit_nothing():
    seqs = [b"ACGT" * 5, b"A" * 23]  # usedLen < 24
    dev = _device_kmers(seqs)
    assert dev[0] == [] and dev[1] == []


@pytest.mark.parametrize("smer_len", [3, 5, 6, 7])
def test_syncmers_match_reference(smer_len):
    rng = np.random.default_rng(100 + smer_len)
    seqs = [ref_impl.random_dna(rng, 160, n_prob=0.02) for _ in range(8)]
    dev = _device_kmers(seqs, syncmer=True, smer_len=smer_len)
    for seq, got in zip(seqs, dev):
        want = _ref_kmers(seq, syncmer=True, smer_len=smer_len)
        assert sorted(got) == sorted(want), f"s={smer_len}"


def test_syncmers_heavy_n():
    rng = np.random.default_rng(42)
    seqs = [ref_impl.random_dna(rng, 300, n_prob=0.1) for _ in range(6)]
    dev = _device_kmers(seqs, syncmer=True, smer_len=5)
    for seq, got in zip(seqs, dev):
        want = _ref_kmers(seq, syncmer=True, smer_len=5)
        assert sorted(got) == sorted(want)


def test_old_format_metamers():
    rng = np.random.default_rng(9)
    seqs = [ref_impl.random_dna(rng, 120, n_prob=0.02) for _ in range(8)]
    dev = _device_kmers(seqs, kmer_format=1)
    for seq, got in zip(seqs, dev):
        want = _ref_kmers(seq, old=True)
        assert sorted(got) == sorted(want)


def test_lowercase_and_iupac_chars():
    seqs = [b"acgtACGTryswkdbhvm" * 8 + b"n" + b"ACGTacgt" * 6]
    dev = _device_kmers(seqs)
    want = _ref_kmers(seqs[0])
    assert sorted(dev[0]) == sorted(want)
    assert len(want) > 0


def test_reduced_metamers_match_reference():
    """Reduced 16-letter mode: 4-bit AAs + 4-bit codon numbers, AA at
    bits 63..32 (SeqIterator.cpp:29-43 semantics)."""
    rng = np.random.default_rng(161)
    for length in (24, 40, 151):
        seqs = [ref_impl.random_dna(rng, length, n_prob=0.03) for _ in range(6)]
        dev = _device_kmers(seqs, reduced=True)
        for seq, got in zip(seqs, dev):
            want = _ref_kmers(seq, reduced=True)
            assert sorted(got) == sorted(want), f"len={length}"


def test_reduced_aa_part_is_high_32_bits():
    rng = np.random.default_rng(8)
    seqs = [ref_impl.random_dna(rng, 90, n_prob=0.0) for _ in range(4)]
    for kmers in _device_kmers(seqs, reduced=True):
        assert kmers
        for value, _, _ in kmers:
            aa = value >> 32
            for j in range(8):
                assert ((aa >> (4 * j)) & 15) <= 15
            dna = value & 0xFFFFFFFF
            for j in range(8):
                assert ((dna >> (4 * j)) & 15) <= 10


def test_jit_matches_eager_bench_shapes():
    """jit-vs-eager gate at production shapes.

    An XLA build once MISCOMPILED a slice/concat pattern here: mirrored
    per-step window slices packed under an unrolled loop came out of jit
    with the codon order un-reversed while op-by-op eager was correct —
    silently halving classification. The fault is shape-dependent, so
    ``jit_eager_mismatches`` gates extract_metamers' compiled output
    against its eager output at the shapes the byte-parity suites do NOT
    cover (150bp reads in 152-wide buckets, 16-read batches, plus the
    36bp minimal-repro shape). ``chip_smoke.py`` runs the same gate on a
    GPU."""
    from metabuli_tpu.checks import jit_eager_mismatches

    assert jit_eager_mismatches() == []
