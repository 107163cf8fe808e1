"""blastx (SWIPE ``-p 2``): nucleotide queries, translated in their three
frames on the strands that the configuration's ``strands`` names,
against protein records.

A hit is one query frame against a record; its key is
``translate.key(qstrand, qframe, 0, 0)``.  The program aligns a shown hit
over the query's frame as it holds it (``query.aa[3 * qstrand +
qframe]``) and the record, and its ``align_q_start``/``align_q_end``
index that frame's amino acids, so ``walk_pair`` returns the frame.  See
``blastp.py`` for what a mode module holds.
"""

from __future__ import annotations

import numpy as np

from portbench.reference import sw, translate

SYMTYPE = 2


def cells(query: bytes, config: dict, residues: int) -> int:
    """SWIPE's GCUPS count (swipe.cc:1744-1775): the query's bases x its
    strands x the database's residues."""
    return len(query) * len(translate.strands(config)) * residues


def scoring(config: dict) -> tuple[str, np.ndarray]:
    return sw.load_matrix(config["matrix"])


def query_rows(query: np.ndarray, config: dict):
    return translate.query_frames(query, config)


def units(corpus, config: dict):
    n = len(corpus.lens)
    return (corpus.flat, corpus.starts, corpus.lens,
            np.arange(n, dtype=np.int64), np.zeros(n, dtype=np.int64))


def hit_key(answer) -> int:
    return translate.key(answer.qstrand, answer.qframe, 0, 0)


def hit_strand(row_key: np.ndarray, unit_key: np.ndarray):
    return row_key + unit_key


def walk_pair(query: np.ndarray, record: np.ndarray, key: int):
    qs, qf, _, _ = translate.unkey(key)
    return translate.translate(query, qs, qf), record


def stat_lengths(query: bytes, corpus) -> tuple[int, int, int]:
    """The query in codons, bases / 3, as SWIPE's
    hits_init (hits.cc:283-511) and the port's ``stats.py:197-205``
    give them."""
    return len(query) // 3, corpus.residues, len(corpus.lens)
