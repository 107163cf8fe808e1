"""tblastn (SWIPE ``-p 3``): protein queries against nucleotide records,
each translated in its six frames.

A hit is the query against one frame of a record; its key is
``translate.key(0, 0, dstrand, dframe)``.  The program aligns a shown hit
over the query and the record's frame as it holds it (``Hit.dseq``), and
its ``align_d_start``/``align_d_end`` index that frame's amino acids, so
``walk_pair`` returns the frame.  See ``blastp.py`` for what a mode module
holds.
"""

from __future__ import annotations

import numpy as np

from portbench.reference import sw, translate

SYMTYPE = 3


def cells(query: bytes, config: dict, residues: int) -> int:
    """SWIPE's GCUPS count (swipe.cc:1744-1775): 2 x the query's residues
    x the database's bases."""
    return 2 * len(query) * residues


def scoring(config: dict) -> tuple[str, np.ndarray]:
    return sw.load_matrix(config["matrix"])


def query_rows(query: np.ndarray, config: dict):
    return [(0, query)]


def units(corpus, config: dict):
    return translate.record_frames(corpus)


def hit_key(answer) -> int:
    return translate.key(0, 0, answer.dstrand, answer.dframe)


def hit_strand(row_key: np.ndarray, unit_key: np.ndarray):
    return row_key + unit_key


def walk_pair(query: np.ndarray, record: np.ndarray, key: int):
    _, _, ds, df = translate.unkey(key)
    return query, translate.translate(record, ds, df)


def stat_lengths(query: bytes, corpus) -> tuple[int, int, int]:
    """The database in codons, bases / 3, as SWIPE's
    hits_init (hits.cc:283-511) and the port's ``stats.py:197-205``
    give them."""
    return len(query), corpus.residues // 3, len(corpus.lens)
