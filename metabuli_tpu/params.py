"""Typed parameter system (the reference's LocalParameters,
`/root/reference/src/commons/LocalParameters.{h,cpp}`).

Each command owns a dataclass of typed flags with the reference's names and
defaults; ``add_to_parser``/``from_args`` bridge to argparse for the CLI.
Database-side parameters persisted in ``db.parameters`` override user flags
at classify time (`/root/reference/src/commons/common.cpp:88-133`).
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field


def _flag_name(field_name: str) -> str:
    return "--" + field_name.replace("_", "-")


def add_to_parser(parser: argparse.ArgumentParser, cls) -> None:
    for f in dataclasses.fields(cls):
        if f.metadata.get("cli", True) is False:
            continue
        kwargs = {"default": f.default, "help": f.metadata.get("help", "")}
        if f.type in ("bool", bool):
            kwargs["type"] = int
        elif f.type in ("int", int):
            kwargs["type"] = int
        elif f.type in ("float", float):
            kwargs["type"] = float
        else:
            kwargs["type"] = str
        parser.add_argument(_flag_name(f.name), **kwargs)


def from_args(cls, args: argparse.Namespace):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in vars(args).items() if k in names})


@dataclass
class ClassifyParams:
    """Defaults from setClassifyDefaults (`/root/reference/src/workflow/classify.cpp:10-37`)."""

    seq_mode: int = 2
    threads: int = 1
    max_ram: int = 128
    min_score: float = 0.0
    min_sp_score: float = 0.0
    min_cons_cnt: int = 4
    min_cons_cnt_euk: int = 9
    tie_ratio: float = 0.95
    reduced_aa: int = 0
    accession_level: int = 0
    match_per_kmer: int = 4
    hamming_margin: int = 0
    mask_mode: int = 0
    mask_prob: float = 0.9
    syncmer: int = 0
    smer_len: int = 5
    kmer_format: int = 1
    skip_redundancy: int = 0
    em: int = 0
    print_log: int = 0
    print_lineage: int = 0
    max_gap: int = 0
    max_shift: int = 0
    min_ss_match: int = 0  # LocalParameters.cpp:532 (stored by Taxonomer but unused)
    validate_input: int = 0
    validate_db: int = 0
    taxonomy_path: str = ""
    # path to a KronaTools/MMseqs2 krona_prelude.html; when set the krona
    # output is byte-compatible with the reference writer
    # (Reporter.cpp:135-160); empty = embedded self-contained viewer
    krona_prelude: str = ""
    buffer_size: int = 16777216
    random_seed: int = 42
    # MMseqs2-style verbosity (LocalParameters.cpp:1098): 0 = errors only
    # (suppresses the summary/progress lines), 3 = full output (default)
    verbosity: int = 3
    # device execution knobs
    batch_reads: int = field(
        default=2048,
        metadata={"help": "reads per device batch (0 = derive from device "
                          "memory, the QueryIndexer byte-budget analogue)"})
    max_cap: int = field(default=4096, metadata={"help": "hard cap on per-AA candidate fan-out"})
    small_cap: int = field(default=8, metadata={"help": "tier-1 candidate window; AA groups larger than this re-gather at full width"})
    device_tax: int = field(default=1, metadata={"help": "run the taxonomer stages on device (fused program; default). 0 = host taxonomer; device grids fall back to the host path on overflow"})


@dataclass
class BuildParams:
    """Defaults from setDefaults_build (`/root/reference/src/workflow/build.cpp:10-30`)."""

    threads: int = 1
    max_ram: int = 128
    syncmer: int = 0
    smer_len: int = 5
    mask_mode: int = 1
    mask_prob: float = 0.9
    split_num: int = 4096
    reduced_aa: int = 0
    accession_level: int = 0
    validate_input: int = 0
    validate_db: int = 0
    kmer_format: int = 2
    skip_redundancy: int = 1
    db_name: str = ""
    db_date: str = ""
    gtdb: int = 0
    make_library: int = 0
    cds_info: str = ""
    assembly: int = 0
    spacing_mask: str = "11111111"
    buffer_size: int = 16777216
    tinfo_path: str = ""
    # MMseqs2-style verbosity (see ClassifyParams.verbosity)
    verbosity: int = 3
    # device execution knobs
    batch_bases: int = field(
        default=2_000_000, metadata={"help": "bases per device extraction batch"}
    )
    flush_kmers: int = field(
        default=0,
        metadata={"help": "k-mers per out-of-core flush file "
                          "(0 = derive from --max-ram)"},
    )
    gene_prediction: int = field(
        default=1,
        metadata={"help": "restrict extraction to predicted coding frames "
                          "+ extended ORFs (bit-exact Prodigal single-mode "
                          "port for >=100kb non-euk training sequences, "
                          "self-training meta stand-in otherwise — the "
                          "reference's unconditional Prodigal stage, "
                          "IndexCreator.cpp:1128-1218). 0 = all 6 frames. "
                          "Set METABULI_META_BINS to a Prodigal training-"
                          "bin file for bit-exact meta mode (record format "
                          "+ generation recipe: README.md 'Prodigal "
                          "metagenomic training bins')"},
    )
