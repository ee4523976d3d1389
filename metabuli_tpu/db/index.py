"""Device-resident metamer index.

Loads a Metabuli-format database directory into decompressed arrays sized
for device residency:

  values  [N] uint64 sorted metamers
  taxids  [N] uint32 internal taxids (redundancy bit cleared on load,
          `KmerMatcher.cpp:204-205`)
  tax2species / tax2genus [T+1] uint32 dense rank tables (the reference's
          taxId2speciesId map, `KmerMatcher.cpp:56-120`)

Also computes ``max_group``, the largest equal-amino-acid run, which bounds
the match fan-out cap so the capped gather provably never drops candidates.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from .formats import DbParameters, read_db_values
from .taxonomy import Taxonomy


@dataclass
class MetamerIndex:
    values: np.ndarray       # uint64 sorted
    taxids: np.ndarray       # uint32
    taxonomy: Taxonomy
    params: DbParameters
    max_group: int

    @classmethod
    def load(cls, db_dir: str) -> "MetamerIndex":
        params_path = os.path.join(db_dir, "db.parameters")
        params = DbParameters.read(params_path) if os.path.exists(params_path) else DbParameters()
        if not os.path.exists(os.path.join(db_dir, "diffIdx")) and os.path.exists(
            os.path.join(db_dir, "deltaIdx.mtbl")
        ):
            from .formats import read_mtbl_values

            values, taxids = read_mtbl_values(db_dir)
        else:
            values, taxids = read_db_values(db_dir)
        if params.skip_redundancy == 0:
            taxids = taxids & np.uint32(0x7FFFFFFF)
        taxonomy = load_db_taxonomy(db_dir)
        aa = values >> np.uint64(32 if params.reduced_aa else 24)
        if len(aa):
            change = np.nonzero(aa[1:] != aa[:-1])[0]
            bounds = np.concatenate([[-1], change, [len(aa) - 1]])
            max_group = int(np.diff(bounds).max())
        else:
            max_group = 1
        return cls(values=values, taxids=taxids, taxonomy=taxonomy,
                   params=params, max_group=max_group)

    def species_table(self) -> np.ndarray:
        t = self.taxonomy.species_of.astype(np.uint32)
        return t

    def save(self, db_dir: str, split_num: int = 4096):
        from .formats import write_db_files, write_taxid_list

        os.makedirs(db_dir, exist_ok=True)
        write_db_files(db_dir, self.values, self.taxids, split_num,
                       reduced=bool(self.params.reduced_aa))
        self.params.write(os.path.join(db_dir, "db.parameters"))
        self.taxonomy.save(os.path.join(db_dir, "taxonomyDB"))
        write_taxid_list(
            os.path.join(db_dir, "taxID_list"), np.unique(self.taxids)
        )


def load_db_taxonomy(db_dir: str) -> Taxonomy:
    """Taxonomy from a DB dir: our npz cache, else taxonomy/ dmp files
    (`/root/reference/src/commons/common.cpp:50-86` analogue)."""
    npz = os.path.join(db_dir, "taxonomyDB.npz")
    if os.path.exists(npz):
        return Taxonomy.load(npz)
    taxdir = os.path.join(db_dir, "taxonomy")
    if os.path.isdir(taxdir):
        tax = Taxonomy.from_dmp(
            os.path.join(taxdir, "names.dmp"),
            os.path.join(taxdir, "nodes.dmp"),
            os.path.join(taxdir, "merged.dmp"),
        )
        return tax
    binary = os.path.join(db_dir, "taxonomyDB")
    if os.path.exists(binary):
        from .taxdb_binary import read_taxonomy_db

        return read_taxonomy_db(binary)
    raise FileNotFoundError(
        f"no taxonomy found in {db_dir} (expected taxonomyDB[.npz] or taxonomy/ dmp files)"
    )
