"""blastn (SWIPE ``-p 0``): nucleotide queries against nucleotide records,
on the strands that the configuration's ``strands`` names (1 plus, 2
minus, 3 both).

A hit on the minus strand is the query's reverse complement against the
record, which SWIPE reports as the record's minus strand: its alignment
is laid over the query and the record's reverse complement.  See
``blastp.py`` for what a mode module holds.
"""

from __future__ import annotations

import numpy as np

from portbench.generators.genome import revcomp
from portbench.reference import sw

SYMTYPE = 0


def strands(config: dict) -> list[int]:
    return [s for s in (0, 1) if (s + 1) & int(config["strands"])]


def cells(query: bytes, config: dict, residues: int) -> int:
    """Cells of one query's search: its bases x its strands x the
    database's bases."""
    return len(query) * len(strands(config)) * residues


def scoring(config: dict) -> tuple[str, np.ndarray]:
    return sw.nucleotide_matrix(config["match"], config["mismatch"])


def query_rows(query: np.ndarray, config: dict):
    return [(s, revcomp(query) if s else query) for s in strands(config)]


def units(corpus, config: dict):
    n = len(corpus.lens)
    return (corpus.flat, corpus.starts, corpus.lens,
            np.arange(n, dtype=np.int64), np.zeros(n, dtype=np.int64))


def hit_key(answer) -> int:
    """The record's strand: the program records a minus-query hit as
    plus-query, minus-record."""
    return answer.dstrand


def hit_strand(row_key: np.ndarray, unit_key: np.ndarray):
    return row_key + unit_key


def walk_pair(query: np.ndarray, record: np.ndarray, key: int):
    return query, revcomp(record) if key else record


def stat_lengths(query: bytes, corpus) -> tuple[int, int, int]:
    return len(query), corpus.residues, len(corpus.lens)
