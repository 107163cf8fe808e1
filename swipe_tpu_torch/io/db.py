"""Database abstraction: what the search/align/report layers need from a db.

Two implementations exist:

* :class:`FastaDatabase` (here) — reads a FASTA file directly; a new
  capability over the reference engine (which requires formatdb/makeblastdb
  output) used for quick searches and tests.
* ``io.blastdb.BlastDatabase`` — NCBI BLAST v4 format databases,
  byte-compatible with the reference's reader (database.cc).

The interface mirrors the parts of the reference's db layer the engine
actually consumes (swipe.h:303-347): metadata for the report
preamble and statistics, per-sequence fetch with db-side strand/frame
resolution (db_getsequence, database.cc:1237-1401), headers for display, and
the per-(strand, frame) search-unit expansion done by search_chunk
(swipe.cc:1377-1390).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

from .. import trace
from ..alphabet import (MAP_NCBI_AA, MAP_NCBI_NT16, MAP_SOUND, translate,
                        revcompl)
from .fasta import read_fasta, scan_fasta_bytes

__all__ = ["Database", "FastaDatabase", "SearchUnit", "translate_frame"]


def translate_frame(nt: np.ndarray, dstrand: int, dframe: int,
                    gencode: int) -> np.ndarray:
    """One reading frame of a record's nucleotide codes, for the
    translated-db modes: a ``db.translate`` span, its bases counted in
    ``translate.bases``."""
    with trace.span("db.translate", strand=dstrand, frame=dframe,
                    bases=len(nt)):
        aa = translate(nt, dstrand, dframe, gencode)
    trace.count("translate.bases", len(nt))
    return aa


@dataclass(frozen=True)
class SearchUnit:
    """One scoring task: a db sequence in one (strand, frame) orientation."""

    seqno: int
    dstrand: int
    dframe: int
    codes: np.ndarray


class Database:
    """Interface consumed by the engine; see module docstring."""

    title: str = ""
    time_str: str = ""

    # ---- metadata -----------------------------------------------------------
    def seqcount(self) -> int:
        raise NotImplementedError

    def symcount(self) -> int:
        raise NotImplementedError

    def longest(self) -> int:
        raise NotImplementedError

    def is_masked(self) -> bool:
        return False

    def seqcount_masked(self) -> int:
        return self.seqcount()

    def symcount_masked(self) -> int:
        return self.symcount()

    # ---- content ------------------------------------------------------------
    def check_inclusion(self, seqno: int) -> bool:
        """Masked-subset / taxid filtering hook (db_check_inclusion)."""
        return True

    def get_sequence(self, seqno: int, symtype: int, dstrand: int = 0,
                     dframe: int = 0) -> tuple[np.ndarray, int]:
        """Sequence codes in the requested orientation, plus the nt length.

        Mirrors db_getsequence's symtype switch (database.cc:1237-1401):
        protein dbs return aa codes; nucleotide dbs return nt16 codes
        (reverse complement when dstrand=1) in nt modes, or the translated
        frame in translated-db modes.  Second value = nucleotide length
        (dlennt).
        """
        raise NotImplementedError

    def get_header(self, seqno: int) -> str:
        """Display defline for the sequence."""
        raise NotImplementedError

    def get_deflines(self, seqno: int) -> list[str]:
        """All display deflines (BLAST dbs can have several per sequence)."""
        return [self.get_header(seqno)]

    def get_defline_objects(self, seqno: int) -> list:
        """Structured deflines, for views that re-render with their own
        flags (the reference forces show_gis=1 for -m 8/9 and -m 99,
        hits.cc:1751 and 1444/1512)."""
        from .asn1 import Defline
        return [Defline(title=self.get_header(seqno))]

    def get_length(self, seqno: int, symtype: int, dstrand: int = 0,
                   dframe: int = 0) -> tuple[int, int]:
        """(sequence length, nt length) without materializing the codes
        when the backing store can answer cheaply."""
        codes, ntlen = self.get_sequence(seqno, symtype, dstrand, dframe)
        return len(codes), ntlen

    def search_units(self, symtype: int,
                     seqno_range: tuple[int, int] | None = None
                     ) -> Iterator[SearchUnit]:
        """All (seqno, dstrand, dframe) scoring tasks for the search phase.

        ``seqno_range`` restricts to [lo, hi) — a multi-host run gives
        each host its shard without decoding the rest of the database
        (parallel.multihost; the reference's slaves likewise only map
        their assigned chunks, swipe.cc:2273-2286)."""
        translated = symtype in (3, 4)
        lo, hi = seqno_range if seqno_range else (0, self.seqcount())
        for seqno in range(lo, hi):
            if not self.check_inclusion(seqno):
                continue
            if translated:
                for dstrand in range(2):
                    for dframe in range(3):
                        codes, _ = self.get_sequence(
                            seqno, symtype, dstrand, dframe)
                        yield SearchUnit(seqno, dstrand, dframe, codes)
            else:
                codes, _ = self.get_sequence(seqno, symtype, 0, 0)
                yield SearchUnit(seqno, 0, 0, codes)

    def unit_metas(self, symtype: int) -> np.ndarray:
        """[n, 3] (seqno, dstrand, dframe) for every scoring unit, in
        search_units order, WITHOUT decoding sequence data — every host
        of a multi-host run derives the same global unit numbering from
        this."""
        metas = []
        translated = symtype in (3, 4)
        for seqno in range(self.seqcount()):
            if not self.check_inclusion(seqno):
                continue
            if translated:
                for dstrand in range(2):
                    for dframe in range(3):
                        metas.append((seqno, dstrand, dframe))
            else:
                metas.append((seqno, 0, 0))
        return np.array(metas, dtype=np.int64).reshape(len(metas), 3)


class _FlatSeqs:
    """List-like per-record views over one flat concatenated code array.

    Bulk ingestion used np.split to materialize a 570k-element list of
    per-record arrays — a per-record Python loop at Swiss-Prot scale
    that the flat layout makes unnecessary: a record is a slice view,
    created on access.  Supports exactly what the engine consumes from
    the sequence list: len(), integer indexing, iteration."""

    __slots__ = ("codes", "offs")

    def __init__(self, codes: np.ndarray, offs: np.ndarray):
        self.codes = codes
        self.offs = offs

    def __len__(self) -> int:
        return self.offs.size - 1

    def __getitem__(self, i: int) -> np.ndarray:
        n = self.offs.size - 1
        i = int(i)
        if i < 0:                      # list semantics, not slice wraparound
            i += n
        if not 0 <= i < n:
            raise IndexError(f"record {i} of {n}")
        return self.codes[self.offs[i]: self.offs[i + 1]]

    def __iter__(self):
        for i in range(self.offs.size - 1):
            yield self.codes[self.offs[i]: self.offs[i + 1]]


class FastaDatabase(Database):
    """In-memory FASTA database.

    ``dbtype`` is 'nt' or 'aa' (or 'sound'); it must agree with the search
    mode's db side: blastp/blastx want 'aa', blastn/tblastn/tblastx 'nt'.

    ``threads`` sizes the ingestion worker pool: multi-window files are
    scanned/encoded per window concurrently — the analog of the
    reference's pthread-parallel db preprocessing
    (swipe.cc:804, 1684-1699); the CLI wires ``-a`` here.
    """

    # files beyond this are ingested in record-aligned windows: per-window
    # temporaries stay bounded (a whole-file scan allocated ~4-5x the
    # file size at once) and windows can fan out across the worker pool
    BULK_WINDOW = 32 << 20

    def __init__(self, path_or_fp, dbtype: str, db_gencode: int = 1,
                 title: str | None = None, threads: int = 1):
        from .. import native
        with trace.span("setup.db", dbtype=dbtype):
            native.tune_malloc()
            self.dbtype = dbtype
            self.db_gencode = db_gencode
            charmap = {"nt": MAP_NCBI_NT16, "aa": MAP_NCBI_AA,
                       "sound": MAP_SOUND}[dbtype]
            self._seqs: list[np.ndarray] | _FlatSeqs = []
            self._headers: list[str] = []
            self._lens: np.ndarray | None = None
            if isinstance(path_or_fp, str):
                self.title = title if title is not None else path_or_fp
                if not self._ingest_path(path_or_fp, charmap, max(threads, 1)):
                    # NUL / overlong-line / non-ASCII input: the exact
                    # fgets-semantics reader (see scan_fasta_bytes)
                    import io as _io
                    with open(path_or_fp, "rb") as fb:
                        blob = fb.read()
                    self._ingest_records(
                        _io.StringIO(blob.decode("latin-1")), charmap)
            else:
                self.title = title or ""
                self._ingest_records(path_or_fp, charmap)
            if self._lens is None:
                self._lens = np.array([len(s) for s in self._seqs],
                                      dtype=np.int64)
            self._symcount = int(self._lens.sum())
            self.time_str = ""

    def _ingest_records(self, fp, charmap: np.ndarray) -> None:
        """Record-by-record ingestion through the exact fgets reader
        (streams, and byte streams the bulk scanner rejects)."""
        self._seqs = []
        self._headers = []
        self._lens = None
        for desc, raw in read_fasta(fp):
            raw_b = raw.encode("ascii", errors="replace")
            codes = charmap[np.frombuffer(raw_b, dtype=np.uint8)]
            self._seqs.append(codes[codes >= 0].astype(np.int8))
            self._headers.append(desc)

    @staticmethod
    def _bulk_codes(scanned, charmap: np.ndarray):
        """(headers, flat int8 codes, per-record kept counts) from one
        scan_fasta_bytes result: one charmap gather + one filter over the
        byte stream — no per-record work.  Byte-for-byte equal to
        _ingest_records (test_fasta_bulk_parity)."""
        headers, seq_bytes, counts = scanned
        codes_all = charmap[seq_bytes]
        keep = codes_all >= 0
        n_kept = int(np.count_nonzero(keep))
        if n_kept == keep.size:
            # clean FASTA (nothing unmappable): no filter pass at all
            return headers, codes_all.astype(np.int8), \
                np.asarray(counts, dtype=np.int64)
        codes = codes_all[keep].astype(np.int8)
        # kept bytes per record: boundary-differenced running count
        # (int32 unless the stream needs more; byte-level reduceat
        # on bool measured pathologically slow)
        ends = np.cumsum(counts, dtype=np.int64)
        ck = np.cumsum(
            keep, dtype=np.int64 if keep.size >= 2**31 else np.int32)
        run = np.concatenate([[0], ck])[ends]
        kept = np.diff(run, prepend=0).astype(np.int64)
        return headers, codes, kept

    def _finish_bulk(self, headers, codes, kept) -> None:
        offs = np.concatenate([[0], np.cumsum(kept, dtype=np.int64)])
        self._seqs = _FlatSeqs(codes, offs)
        self._headers = headers
        self._lens = kept

    def _ingest_bulk(self, scanned, charmap: np.ndarray) -> None:
        """Single-window vectorized ingestion (scan_fasta_bytes)."""
        self._finish_bulk(*self._bulk_codes(scanned, charmap))

    def _ingest_path(self, path: str, charmap: np.ndarray,
                     threads: int) -> bool:
        """Bulk-ingest a FASTA file; False -> caller uses the exact
        fgets reader (scan_fasta_bytes rejected some window).

        Large files are cut at record starts ("\\n>") into ~BULK_WINDOW
        pieces, each scanned/encoded independently (concurrently when
        ``threads`` > 1) and concatenated — same results as the
        whole-file scan with bounded temporaries."""
        import mmap
        import os as _os
        size = _os.path.getsize(path)
        with open(path, "rb") as fb:
            if size <= self.BULK_WINDOW:
                scanned = scan_fasta_bytes(fb.read())
                if scanned is None:
                    return False
                self._ingest_bulk(scanned, charmap)
                return True
            mm = mmap.mmap(fb.fileno(), 0, access=mmap.ACCESS_READ)
            try:
                cuts = [0]
                pos = self.BULK_WINDOW
                while pos < size:
                    nxt = mm.find(b"\n>", pos - 1)
                    if nxt < 0:
                        break
                    cuts.append(nxt + 1)
                    pos = nxt + 1 + self.BULK_WINDOW
                cuts.append(size)

                def one(i):
                    scanned = scan_fasta_bytes(mm[cuts[i]: cuts[i + 1]])
                    if scanned is None:
                        return None
                    return self._bulk_codes(scanned, charmap)

                if threads > 1 and len(cuts) > 2:
                    from concurrent.futures import ThreadPoolExecutor
                    with ThreadPoolExecutor(threads) as ex:
                        parts = list(ex.map(one, range(len(cuts) - 1)))
                else:
                    parts = [one(i) for i in range(len(cuts) - 1)]
            finally:
                mm.close()
        if any(p is None for p in parts):
            return False
        headers: list[str] = []
        for h, _, _ in parts:
            headers.extend(h)
        self._finish_bulk(headers,
                          np.concatenate([c for _, c, _ in parts]),
                          np.concatenate([k for _, _, k in parts]))
        return True

    def seqcount(self) -> int:
        return len(self._seqs)

    def symcount(self) -> int:
        return self._symcount

    def longest(self) -> int:
        if self._lens is not None:
            return int(self._lens.max(initial=0))
        return max((len(s) for s in self._seqs), default=0)

    def get_sequence(self, seqno: int, symtype: int, dstrand: int = 0,
                     dframe: int = 0) -> tuple[np.ndarray, int]:
        s = self._seqs[seqno]
        if self.dbtype != "nt":
            return s, len(s)
        ntlen = len(s)
        if symtype in (3, 4):
            return translate_frame(s, dstrand, dframe, self.db_gencode), \
                ntlen
        if dstrand:
            return revcompl(np.asarray(s, dtype=np.int8)), ntlen
        return s, ntlen

    def get_header(self, seqno: int) -> str:
        return self._headers[seqno]

