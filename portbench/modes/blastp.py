"""blastp (SWIPE ``-p 1``): protein queries against protein records.

A mode module holds what the benchmark needs to know of one search mode:
the cells a query's search costs, and, for the plain reference, how a
query and the database's records become the rows and subjects it scores,
the key that tells a record's hits apart (``hit_key`` of a returned hit,
``hit_strand`` of a scored (row, subject) pair: the two agree), what a
shown alignment is laid over, and the lengths of the statistics.  The
harness finds it by the SWIPE program name of the configuration's
``symtype``.
"""

from __future__ import annotations

import numpy as np

from portbench.reference import sw

SYMTYPE = 1


def cells(query: bytes, config: dict, residues: int) -> int:
    """Cells of one query's search: its residues x the database's."""
    return len(query) * residues


def scoring(config: dict) -> tuple[str, np.ndarray]:
    """(letters, score matrix) of the reference."""
    return sw.load_matrix(config["matrix"])


def query_rows(query: np.ndarray, config: dict):
    """[(row key, letters)] of each query row the search scores."""
    return [(0, query)]


def units(corpus, config: dict):
    """The subjects the reference scores: (letters, starts, lengths,
    record number, key) of each."""
    n = len(corpus.lens)
    return (corpus.flat, corpus.starts, corpus.lens,
            np.arange(n, dtype=np.int64), np.zeros(n, dtype=np.int64))


def hit_key(answer) -> int:
    """The key of a returned hit (its ``qstrand``, ``qframe``,
    ``dstrand``, ``dframe``) among the hits of its record."""
    return 0


def hit_strand(row_key: np.ndarray, unit_key: np.ndarray):
    """The key of the hit of a (row, subject) pair, as ``hit_key`` gives
    it for the program's hit."""
    return row_key + unit_key


def walk_pair(query: np.ndarray, record: np.ndarray, key: int):
    """(query, subject) letters that a shown alignment of the hit with
    ``key`` is laid over."""
    return query, record


def stat_lengths(query: bytes, corpus) -> tuple[int, int, int]:
    """(query length, database residues, database records) of the
    E-value statistics."""
    return len(query), corpus.residues, len(corpus.lens)
