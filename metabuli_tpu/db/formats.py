"""Reference-compatible database file formats.

Metabuli databases are a directory of flat files
(`/root/reference/src/commons/IndexCreator.cpp:1251-1272`,
`SURVEY.md` §2.4):

  diffIdx        u16 stream: sorted u64 metamers stored as deltas in 15-bit
                 chunks, most-significant first, MSB=1 terminates a number
                 (`IndexCreator.cpp:874-892`, reader `KmerMatcher.h:282-297`).
  info           u32 per-metamer taxid; bit 31 flags redundancy unless the
                 DB was built with --skip-redundancy (`KmerMatcher.cpp:204-205`).
  split          4096 x {u64 ADkmer, u64 diffIdxOffset, u64 infoIdxOffset}
                 entries at amino-acid boundaries (`Kmer.h:111-119`).
  taxID_list     one internal taxid per line.
  acc2taxid.map  accession\ttaxid (3 columns in accession-level DBs).
  db.parameters  text key\tvalue metadata re-applied at classify time
                 (`/root/reference/src/commons/common.cpp:88-133`).

The codec here is numpy-vectorized (no per-element Python); the delta format
is retained as the *interchange* format only — in host and device memory the table is
kept decompressed for binary search.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

SPLIT_DTYPE = np.dtype(
    [("ADkmer", "<u8"), ("diffIdxOffset", "<u8"), ("infoIdxOffset", "<u8")]
)


def delta_encode(values: np.ndarray, prev: int = 0) -> np.ndarray:
    """Sorted uint64 values -> u16 delta stream (`IndexCreator.cpp:874-892`).

    ``prev`` continues an existing stream (the delta of the first value is
    taken against it), enabling block-streamed writes.
    """
    values = np.asarray(values, dtype=np.uint64)
    if len(values) == 0:
        return np.zeros(0, np.uint16)
    diffs = np.empty_like(values)
    diffs[0] = values[0] - np.uint64(prev)
    np.subtract(values[1:], values[:-1], out=diffs[1:])
    # chunks per diff: 1 + floor(bit_length(diff)-1, /15) with diff=0 -> 1
    bl = np.zeros(len(diffs), np.int64)
    tmp = diffs.copy()
    for shift in (32, 16, 8, 4, 2, 1):
        mask = tmp >= (np.uint64(1) << np.uint64(shift))
        bl[mask] += shift
        tmp[mask] >>= np.uint64(shift)
    bl += tmp.astype(np.int64)  # add 1 if tmp==1 (diff>0), 0 if diff==0
    nchunks = np.maximum(1, (bl + 14) // 15)
    total = int(nchunks.sum())
    out = np.zeros(total, np.uint16)
    ends = np.cumsum(nchunks) - 1
    starts = ends - nchunks + 1
    max_chunks = int(nchunks.max())
    for j in range(max_chunks):
        sel = nchunks > j
        # chunk j (most-significant first) of each selected diff
        shift = ((nchunks[sel] - 1 - j) * 15).astype(np.uint64)
        chunk = ((diffs[sel] >> shift) & np.uint64(0x7FFF)).astype(np.uint16)
        is_last = nchunks[sel] - 1 == j
        out[(starts[sel] + j)] = chunk | (is_last.astype(np.uint16) << 15)
    return out


def delta_decode(stream: np.ndarray, base: int = 0) -> np.ndarray:
    """u16 delta stream -> sorted uint64 values (vectorized reader)."""
    stream = np.asarray(stream, dtype=np.uint16)
    if len(stream) == 0:
        return np.zeros(0, np.uint64)
    flags = (stream & 0x8000) != 0
    ends = np.nonzero(flags)[0]
    n = len(ends)
    starts = np.empty(n, np.int64)
    starts[0] = 0
    starts[1:] = ends[:-1] + 1
    chunk_num = np.repeat(np.arange(n), ends - starts + 1)
    pos = np.arange(len(stream), dtype=np.int64)
    rev = (ends[chunk_num] - pos).astype(np.uint64)
    contrib = (stream.astype(np.uint64) & np.uint64(0x7FFF)) << (rev * np.uint64(15))
    diffs = np.add.reduceat(contrib, starts)
    return np.cumsum(diffs, dtype=np.uint64) + np.uint64(base)


class StreamingDeltaReader:
    """Block-streamed decode of a diffIdx/info file pair.

    The host-side analogue of the reference's ``DeltaIdxReader``
    (`/root/reference/src/commons/DeltaIdxReader.h:19-290`): decodes the
    MSB-terminated 15-bit chunk stream in bounded blocks, carrying the
    running value across blocks, so GTDB-scale flush files never need to be
    resident at once.
    """

    def __init__(self, diff_path: str, info_path: str,
                 block_values: int = 1 << 20):
        self._stream = np.memmap(diff_path, dtype=np.uint16, mode="r") \
            if os.path.getsize(diff_path) else np.zeros(0, np.uint16)
        self._info = np.memmap(info_path, dtype=np.uint32, mode="r") \
            if os.path.getsize(info_path) else np.zeros(0, np.uint32)
        self._block = block_values
        self._chunk_pos = 0      # next unread u16
        self._info_pos = 0       # next unread info entry
        self._last = 0           # running decoded value
        # the info file has exactly one entry per encoded value
        self.total_values = len(self._info)

    @property
    def exhausted(self) -> bool:
        return self._info_pos >= self.total_values

    def read_block(self) -> tuple[np.ndarray, np.ndarray]:
        """Decode up to ``block_values`` next values; returns (values, infos)."""
        if self.exhausted:
            return np.zeros(0, np.uint64), np.zeros(0, np.uint32)
        # find the terminator of the block's last value: scan a window that
        # surely contains block_values terminators (<= 5 chunks per value)
        start = self._chunk_pos
        window = np.asarray(self._stream[start : start + self._block * 5 + 8])
        flag_idx = np.nonzero((window & 0x8000) != 0)[0]
        take = min(self._block, len(flag_idx))
        end = start + int(flag_idx[take - 1]) + 1
        vals = delta_decode(np.asarray(self._stream[start:end]), base=self._last)
        infos = np.asarray(self._info[self._info_pos : self._info_pos + take])
        self._chunk_pos = end
        self._info_pos += take
        self._last = int(vals[-1])
        return vals, infos


class StreamingDbWriter:
    """Block-streamed diffIdx/info/split writer (write_db_files, streamed).

    Accepts globally sorted blocks; maintains the delta-encoding carry and
    the reference's split-checkpoint protocol (`IndexCreator.cpp:823-855`,
    `IndexCreator.h:436-448`): when the written-info count reaches a
    multiple of total/(split_num-1) the writer arms with that k-mer's AA;
    the next k-mer whose AA differs is recorded — value, u16 count and
    info count all INCLUDING it — and checkpoints passed while armed are
    consumed (byte-identical to the reference writer, locked by
    tests/test_reference_differential.py build parity).
    """

    def __init__(self, db_dir: str, total_estimate: int,
                 split_num: int = 4096, reduced: bool = False):
        os.makedirs(db_dir, exist_ok=True)
        self._diff_fh = open(os.path.join(db_dir, "diffIdx"), "wb")
        self._info_fh = open(os.path.join(db_dir, "info"), "wb")
        self._split_path = os.path.join(db_dir, "split")
        self._split_num = split_num
        self._aa_shift = np.uint64(32 if reduced else 24)
        # reference: sizeOfSplit = total/(splitNum-1) with NO floor — a
        # tiny DB (total < splitNum-1) gets sizeOfSplit == 0 and an
        # all-zero split file; the offset list holds only splitNum-1
        # finite checkpoints (idx 1..splitNum-1, then UINT64_MAX)
        self._size_of_split = total_estimate // max(1, split_num - 1)
        self._splits = np.zeros(split_num, SPLIT_DTYPE)
        self._split_idx = 1
        self._armed_aa = None  # AA of the checkpoint k-mer while armed
        self._prev_value = 0   # last value written (delta carry)
        self._diff_cnt = 0     # u16 chunks written
        self._info_cnt = 0     # values written
        self._offset_idx = 1   # next entry of the finite offset list

    def _next_off(self):
        """Next checkpoint writeCnt, or None for the UINT64_MAX sentinel
        (offset list exhausted / sizeOfSplit == 0)."""
        if self._size_of_split == 0 or self._offset_idx >= self._split_num:
            return None
        return self._offset_idx * self._size_of_split

    def write_block(self, values: np.ndarray, taxids: np.ndarray) -> None:
        if len(values) == 0:
            return
        values = np.asarray(values, np.uint64)
        stream = delta_encode(values, prev=self._prev_value)
        stream.tofile(self._diff_fh)
        np.asarray(taxids, np.uint32).tofile(self._info_fh)

        # split bookkeeping (vectorized over the block); indices below are
        # LOCAL to this block, counts are global
        flags_end = np.nonzero((stream & 0x8000) != 0)[0]
        diff_cnt_after = self._diff_cnt + flags_end + 1
        aa = values >> self._aa_shift
        n = len(values)
        g0 = self._info_cnt
        search = 0  # local index to search an AA change from
        while self._split_idx < self._split_num:
            if self._armed_aa is None:
                no = self._next_off()
                if no is None or no > g0 + n:
                    break
                c = no - 1 - g0  # local; >= 0 (see invariant)
                self._armed_aa = np.uint64(aa[c])
                self._offset_idx += 1
                search = c + 1
                if search >= n:
                    break
            changes = np.nonzero(aa[search:] != self._armed_aa)[0]
            if len(changes) == 0:
                search = n
                break  # change not in this block; stay armed
            j = search + int(changes[0])
            # offsets passed while armed are consumed (their re-arm is a
            # no-op inside one AA group)
            while True:
                no = self._next_off()
                if no is None or no > g0 + j:
                    break
                self._offset_idx += 1
            self._splits[self._split_idx] = (
                int(values[j]), int(diff_cnt_after[j]), g0 + j + 1)
            self._split_idx += 1
            no = self._next_off()
            if no is not None and no == g0 + j + 1:
                self._armed_aa = np.uint64(aa[j])
                self._offset_idx += 1
            else:
                self._armed_aa = None
            search = j + 1
            if search >= n:
                break

        self._prev_value = int(values[-1])
        self._diff_cnt += len(stream)
        self._info_cnt += n

    def finalize(self) -> int:
        self._diff_fh.close()
        self._info_fh.close()
        self._splits.tofile(self._split_path)
        return self._info_cnt


def merge_flush_files(
    db_dir: str,
    flush_pairs: list[tuple[str, str]],
    species_of: np.ndarray,
    lca_segments,
    split_num: int = 4096,
    reduced: bool = False,
    block_values: int = 1 << 20,
) -> int:
    """K-way merge of sorted flush files with (value, species)-dedup + LCA.

    The out-of-core analogue of `IndexCreator::mergeTargetFiles`
    (`IndexCreator.h:322-472`): each round drains every reader up to the
    smallest last-buffered value (ties fully loaded), so a global
    sort + dedup of the round's block is safe. Returns the merged k-mer
    count.
    """
    readers = [StreamingDeltaReader(d, i, block_values) for d, i in flush_pairs]
    total = sum(r.total_values for r in readers)
    writer = StreamingDbWriter(db_dir, total, split_num, reduced)
    bufs = [[np.zeros(0, np.uint64), np.zeros(0, np.uint32)] for _ in readers]

    def refill(i):
        v, t = readers[i].read_block()
        if len(v):
            bufs[i][0] = np.concatenate([bufs[i][0], v])
            bufs[i][1] = np.concatenate([bufs[i][1], t])

    while True:
        for i, r in enumerate(readers):
            if len(bufs[i][0]) == 0 and not r.exhausted:
                refill(i)
        active = [i for i in range(len(readers)) if len(bufs[i][0])]
        if not active:
            break
        lasts = [int(bufs[i][0][-1]) for i in active if not readers[i].exhausted]
        if lasts:
            cut = min(lasts)
            # ensure every copy of `cut` is buffered
            stable = False
            while not stable:
                stable = True
                for i in active:
                    while (not readers[i].exhausted
                           and int(bufs[i][0][-1]) <= cut):
                        refill(i)
                        stable = False
                lasts = [int(bufs[i][0][-1]) for i in active
                         if not readers[i].exhausted]
                new_cut = min(lasts) if lasts else cut
                if new_cut != cut:
                    cut = new_cut
                    stable = False
        else:
            cut = None

        vals_parts, tax_parts = [], []
        for i in active:
            v, t = bufs[i]
            k = len(v) if cut is None else int(np.searchsorted(v, np.uint64(cut), side="right"))
            if k:
                vals_parts.append(v[:k])
                tax_parts.append(t[:k])
                bufs[i][0] = v[k:]
                bufs[i][1] = t[k:]
        if not vals_parts:
            continue
        values = np.concatenate(vals_parts)
        taxids = np.concatenate(tax_parts)
        species = species_of[taxids & np.uint32(0x7FFFFFFF)]
        from ..native.sort import lexsort_vst

        order = lexsort_vst(values, species, taxids)
        values, taxids, species = values[order], taxids[order], species[order]
        new_group = np.ones(len(values), bool)
        new_group[1:] = (values[1:] != values[:-1]) | (species[1:] != species[:-1])
        group_id = np.cumsum(new_group) - 1
        lca = lca_segments(taxids.astype(np.int64), group_id)
        writer.write_block(values[new_group], lca.astype(np.uint32))

    return writer.finalize()


def count_deltas(stream: np.ndarray) -> int:
    """Number of encoded values (validateDatabase's consistency check,
    `/root/reference/src/util/validateDatabase.cpp:17-143`)."""
    stream = np.asarray(stream, dtype=np.uint16)
    return int(((stream & 0x8000) != 0).sum())


@dataclass
class DbParameters:
    """db.parameters contents (`IndexCreator.cpp:1249-1272`)."""

    db_name: str = ""
    creation_date: str = ""
    version: str = "metabuli_tpu"
    reduced_aa: int = 0
    accession_level: int = 0
    mask_mode: int = 1
    mask_prob: float = 0.9
    skip_redundancy: int = 1
    syncmer: int = 0
    smer_len: int = 5
    kmer_format: int = 2
    extras: dict = field(default_factory=dict)

    def write(self, path: str):
        with open(path, "w") as fh:
            fh.write(f"DB_name\t{self.db_name}\n")
            fh.write(f"Creation_date\t{self.creation_date}\n")
            fh.write(f"Metabuli commit used to create the DB\t{self.version}\n")
            fh.write(f"Reduced_alphabet\t{self.reduced_aa}\n")
            fh.write(f"Accession_level\t{self.accession_level}\n")
            fh.write(f"Mask_mode\t{self.mask_mode}\n")
            fh.write(f"Mask_prob\t{self.mask_prob:f}\n")
            fh.write(f"Skip_redundancy\t{self.skip_redundancy}\n")
            fh.write(f"Syncmer\t{self.syncmer}\n")
            if self.syncmer == 1:
                fh.write(f"Syncmer_len\t{self.smer_len}\n")
            fh.write(f"Kmer_format\t{self.kmer_format}\n")
            for k, v in self.extras.items():
                fh.write(f"{k}\t{v}\n")

    @classmethod
    def read(cls, path: str) -> "DbParameters":
        p = cls()
        with open(path) as fh:
            for line in fh:
                if "\t" not in line:
                    continue
                key, _, val = line.rstrip("\n").partition("\t")
                if key == "DB_name":
                    p.db_name = val
                elif key == "Creation_date":
                    p.creation_date = val
                elif key == "Metabuli commit used to create the DB":
                    p.version = val
                elif key == "Reduced_alphabet":
                    p.reduced_aa = int(val)
                elif key == "Accession_level":
                    p.accession_level = int(val)
                elif key == "Mask_mode":
                    p.mask_mode = int(val)
                elif key == "Mask_prob":
                    p.mask_prob = float(val)
                elif key == "Skip_redundancy":
                    p.skip_redundancy = int(val)
                elif key == "Syncmer":
                    p.syncmer = int(val)
                elif key == "Syncmer_len":
                    p.smer_len = int(val)
                elif key == "Kmer_format":
                    p.kmer_format = int(val)
                else:
                    p.extras[key] = val
        return p


def write_db_files(
    db_dir: str,
    values: np.ndarray,
    taxids: np.ndarray,
    split_num: int = 4096,
    reduced: bool = False,
):
    """Write diffIdx / info / split for a sorted, deduplicated metamer table.

    Split entries are placed at the first amino-acid-part change at or after
    every (total/(split_num-1))-th k-mer, mirroring
    `IndexCreator.cpp:817-872` (entry i records the k-mer value *before* the
    boundary and the offsets where the next k-mer starts).
    """
    os.makedirs(db_dir, exist_ok=True)
    values = np.asarray(values, np.uint64)
    taxids = np.asarray(taxids, np.uint32)
    n = len(values)
    stream = delta_encode(values)
    stream.tofile(os.path.join(db_dir, "diffIdx"))
    taxids.tofile(os.path.join(db_dir, "info"))

    splits = np.zeros(split_num, SPLIT_DTYPE)
    if n > 0:
        # cumulative u16 count after writing each k-mer
        flags_end = np.nonzero((stream & 0x8000) != 0)[0]
        diff_cnt_after = flags_end + 1  # per k-mer i: chunks written so far
        aa = values >> np.uint64(32 if reduced else 24)
        # Exact replay of the reference's per-write event machine
        # (IndexCreator.cpp:823-855): after the k-mers written reaches a
        # multiple of sizeOfSplit the writer "arms" with that k-mer's AA;
        # the next k-mer whose AA differs is recorded — value, u16 count
        # and info count all INCLUDING it — and offsets passed while armed
        # are consumed (their re-base is a no-op inside one AA group).
        # NO floor on sizeOfSplit (tiny DBs get 0 => an all-zero split
        # file), and only splitNum-1 finite offsets exist (idx
        # 1..splitNum-1, then UINT64_MAX)
        size_of_split = n // max(1, split_num - 1)
        aa_change = np.nonzero(aa[1:] != aa[:-1])[0] + 1
        split_idx = 1
        offset_idx = 1
        next_off = lambda: (offset_idx * size_of_split
                            if size_of_split and offset_idx < split_num
                            else None)
        armed_c = None
        while split_idx < split_num:
            if armed_c is None:
                no = next_off()
                if no is None or no > n:
                    break
                armed_c = no - 1
                offset_idx += 1
            k = np.searchsorted(aa_change, armed_c, side="right")
            if k >= len(aa_change):
                break
            j = int(aa_change[k])
            while (no := next_off()) is not None and no <= j:
                offset_idx += 1
            splits[split_idx] = (values[j], int(diff_cnt_after[j]), j + 1)
            split_idx += 1
            if (no := next_off()) is not None and no == j + 1:
                armed_c = j
                offset_idx += 1
            else:
                armed_c = None
    splits.tofile(os.path.join(db_dir, "split"))


def read_db_values(db_dir: str) -> tuple[np.ndarray, np.ndarray]:
    """Load and decompress diffIdx + info into (values u64, taxids u32)."""
    stream = np.fromfile(os.path.join(db_dir, "diffIdx"), dtype=np.uint16)
    taxids = np.fromfile(os.path.join(db_dir, "info"), dtype=np.uint32)
    values = delta_decode(stream)
    if len(values) != len(taxids):
        raise ValueError(
            f"diffIdx k-mer count {len(values)} != info count {len(taxids)}"
        )
    return values, taxids


def write_taxid_list(path: str, taxids) -> None:
    with open(path, "w") as fh:
        for t in taxids:
            fh.write(f"{int(t)}\n")


def read_taxid_list(path: str) -> np.ndarray:
    with open(path) as fh:
        return np.array([int(x) for x in fh.read().split()], np.int64)


# ------------------------------------------------------------------ .mtbl
# Newest reference DB format (`/root/reference/src/commons/Kmer.h:121-165`,
# reader `KmerMatcher.cpp:780-1069`): the sorted (metamer, 30-bit id) pairs
# form 94-bit numbers value94 = (metamer << 30) | id, delta-compressed in
# the same MSB-terminated 15-bit chunk stream as diffIdx
# (Metamer::substract/add implement exactly base-2^30 borrow arithmetic).

MTBL_SPLIT_DTYPE = np.dtype([
    ("metamer", "<u8"), ("id", "<u4"), ("pad", "<u4"), ("offset", "<u8"),
])


def _combined_chunks(hi: np.ndarray, lo: np.ndarray, shift: int) -> np.ndarray:
    """15-bit chunk at bit offset `shift` of (hi << 30 | lo) values."""
    if shift >= 30:
        return ((hi >> np.uint64(shift - 30)) & np.uint64(0x7FFF)).astype(np.uint16)
    part = (lo >> np.uint64(shift)) & np.uint64(0x7FFF)
    if 30 - shift < 15:
        part |= (hi << np.uint64(30 - shift)) & np.uint64(0x7FFF)
    return part.astype(np.uint16)


def mtbl_encode(values: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Sorted (metamer u64, id u30) pairs -> u16 .mtbl delta stream."""
    values = np.asarray(values, np.uint64)
    ids = np.asarray(ids, np.uint64) & np.uint64(0x3FFFFFFF)
    n = len(values)
    if n == 0:
        return np.zeros(0, np.uint16)
    # 94-bit difference with base-2^30 borrow
    prev_v = np.concatenate([[np.uint64(0)], values[:-1]])
    prev_i = np.concatenate([[np.uint64(0)], ids[:-1]])
    borrow = ids < prev_i
    lo = (ids - prev_i) & np.uint64(0x3FFFFFFF)
    hi = values - prev_v - borrow.astype(np.uint64)

    # chunks needed: position of highest set bit across (hi, lo)
    bl = np.zeros(n, np.int64)
    tmp = hi.copy()
    for s in (32, 16, 8, 4, 2, 1):
        m = tmp >= (np.uint64(1) << np.uint64(s))
        bl[m] += s
        tmp[m] >>= np.uint64(s)
    bl += tmp.astype(np.int64)  # hi bit length
    total_bits = np.where(bl > 0, bl + 30, 0)
    lo_bl = np.zeros(n, np.int64)
    tmp = lo.copy()
    for s in (16, 8, 4, 2, 1):
        m = tmp >= (np.uint64(1) << np.uint64(s))
        lo_bl[m] += s
        tmp[m] >>= np.uint64(s)
    lo_bl += tmp.astype(np.int64)
    total_bits = np.maximum(total_bits, lo_bl)
    nchunks = np.maximum(1, (total_bits + 14) // 15)
    total = int(nchunks.sum())
    out = np.zeros(total, np.uint16)
    ends = np.cumsum(nchunks) - 1
    starts = ends - nchunks + 1
    for j in range(int(nchunks.max())):
        sel = nchunks > j
        shift = ((nchunks[sel] - 1 - j) * 15).astype(np.int64)
        # gather chunks at per-element shifts: loop over distinct shifts
        chunk = np.zeros(sel.sum(), np.uint16)
        sh_vals = np.unique(shift)
        hi_s = hi[sel]
        lo_s = lo[sel]
        for sv in sh_vals:
            mask = shift == sv
            chunk[mask] = _combined_chunks(hi_s[mask], lo_s[mask], int(sv))
        is_last = (nchunks[sel] - 1) == j
        out[starts[sel] + j] = chunk | (is_last.astype(np.uint16) << 15)
    return out


def mtbl_decode(stream: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """u16 .mtbl delta stream -> (metamers u64, ids u32)."""
    stream = np.asarray(stream, np.uint16)
    if len(stream) == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint32)
    flags = (stream & 0x8000) != 0
    ends = np.nonzero(flags)[0]
    n = len(ends)
    starts = np.empty(n, np.int64)
    starts[0] = 0
    starts[1:] = ends[:-1] + 1
    chunk_num = np.repeat(np.arange(n), ends - starts + 1)
    pos = np.arange(len(stream), dtype=np.int64)
    rev = (ends[chunk_num] - pos) * 15
    payload = stream.astype(np.uint64) & np.uint64(0x7FFF)
    # diff split into hi (bits >= 30) and lo (bits < 30)
    lo_contrib = np.where(
        rev < 30, payload << rev.astype(np.uint64), np.uint64(0)
    )
    hi_contrib = np.where(
        rev >= 30, payload << (rev - 30).clip(min=0).astype(np.uint64),
        np.uint64(0),
    )
    d_lo = np.add.reduceat(lo_contrib, starts)   # may exceed 30 bits
    d_hi = np.add.reduceat(hi_contrib, starts)
    d_hi += d_lo >> np.uint64(30)
    d_lo &= np.uint64(0x3FFFFFFF)
    # cumulative base-2^30 addition
    ids = np.cumsum(d_lo)
    carry = ids >> np.uint64(30)
    ids &= np.uint64(0x3FFFFFFF)
    metamers = np.cumsum(d_hi) + carry
    return metamers.astype(np.uint64), ids.astype(np.uint32)


def write_mtbl_files(db_dir: str, values: np.ndarray, ids: np.ndarray,
                     split_num: int = 4096) -> None:
    """Write deltaIdx.mtbl + deltaIdxSplits.mtbl (`KmerMatcher.cpp:784-785`)."""
    os.makedirs(db_dir, exist_ok=True)
    stream = mtbl_encode(values, ids)
    stream.tofile(os.path.join(db_dir, "deltaIdx.mtbl"))
    splits = np.zeros(split_num, MTBL_SPLIT_DTYPE)
    n = len(values)
    if n:
        flags_end = np.nonzero((stream & 0x8000) != 0)[0]
        size = max(1, n // max(1, split_num - 1))
        for i in range(1, split_num):
            k = i * size
            if k >= n:
                break
            splits[i] = (values[k - 1], ids[k - 1], 0, flags_end[k - 1] + 1)
    splits.tofile(os.path.join(db_dir, "deltaIdxSplits.mtbl"))


def read_mtbl_values(db_dir: str) -> tuple[np.ndarray, np.ndarray]:
    stream = np.fromfile(os.path.join(db_dir, "deltaIdx.mtbl"), dtype=np.uint16)
    return mtbl_decode(stream)
