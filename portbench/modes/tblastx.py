"""tblastx (SWIPE ``-p 4``): nucleotide queries, translated in their
three frames on the strands that the configuration's ``strands`` names,
against nucleotide records, each translated in its six frames.

A hit is one query frame against one frame of a record; its key is
``translate.key(qstrand, qframe, dstrand, dframe)``.  The program aligns
a shown hit over both frames as it holds them (``query.aa[3 * qstrand +
qframe]``, ``Hit.dseq``), and its coordinates index their amino acids,
so ``walk_pair`` returns the frames.  See ``blastp.py`` for what a mode
module holds.
"""

from __future__ import annotations

import numpy as np

from portbench.reference import sw, translate

SYMTYPE = 4


def cells(query: bytes, config: dict, residues: int) -> int:
    """SWIPE's GCUPS count (swipe.cc:1744-1775): 2 x the query's bases x
    its strands x the database's bases."""
    return 2 * len(query) * len(translate.strands(config)) * residues


def scoring(config: dict) -> tuple[str, np.ndarray]:
    return sw.load_matrix(config["matrix"])


def query_rows(query: np.ndarray, config: dict):
    return translate.query_frames(query, config)


def units(corpus, config: dict):
    return translate.record_frames(corpus)


def hit_key(answer) -> int:
    return translate.key(answer.qstrand, answer.qframe, answer.dstrand,
                         answer.dframe)


def hit_strand(row_key: np.ndarray, unit_key: np.ndarray):
    return row_key + unit_key


def walk_pair(query: np.ndarray, record: np.ndarray, key: int):
    qs, qf, ds, df = translate.unkey(key)
    return (translate.translate(query, qs, qf),
            translate.translate(record, ds, df))


def stat_lengths(query: bytes, corpus) -> tuple[int, int, int]:
    """The query and the database in codons, bases / 3, as SWIPE's
    hits_init (hits.cc:283-511) and the port's ``stats.py:197-205``
    give them; tblastx also reads the ungapped row of its matrix, which
    the configuration's ``statistics`` states."""
    return len(query) // 3, corpus.residues // 3, len(corpus.lens)
