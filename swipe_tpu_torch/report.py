"""Output rendering: BLAST-like plain, XML, and tabular formats.

Byte-level parity targets in the reference:
* expect-value formatting: hits_show_expect[_nospace] (hits.cc:1177-1213)
* alignment statistics + coordinate remapping: count_align/whole_align
  (hits.cc:815-1175)
* 60-column pairwise rendering: putalignop/show_align (hits.cc:647-813)
* plain report: hits_show_plain (hits.cc:1791-1945), preamble args_show
  (swipe.cc:665-782), timing block clock_stop (swipe.cc:1716-1790)
* XML: hits_show_xml (hits.cc:1660-1727); TSV: hits_show_tsv (:1729-1789)
* defline display rules: show_deflines (asnparse.cc:889-971)
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

from . import trace
from .alphabet import SYM_NCBI_AA, SYM_NCBI_NT16, SYM_SOUND
from .hits import Hit, HitList

__all__ = ["format_expect", "format_expect_nospace", "render_header",
           "Reporter", "ParalignInfo", "defline_split", "make_anchor"]

LONG_MAX = 2**63 - 1
PROGRAM = "SWIPE 2.1.1"
PROGRAM_TPU = "swipe-tpu 0.1.0"
REFLINE = ("Reference: T. Rognes (2011) Faster Smith-Waterman database "
           "searches\nwith inter-sequence SIMD parallelisation, "
           "BMC Bioinformatics, 12:221.")
REFLINE1 = ("Reference: T. Rognes (2011) Faster Smith-Waterman database "
            "searches with inter-sequence SIMD parallelisation, "
            "BMC Bioinformatics, 12:221.")


def format_expect(expect: float) -> str:
    """hits_show_expect: fixed-ish-width E-value field."""
    if expect < 1e-180:
        return "0.0  "
    if expect < 9.5e-100:
        return ("%-6.0e" % expect)[1:]
    if expect < 0.00095:
        return "%-5.0e" % expect
    if expect < 0.0995:
        return "%-5.3f" % expect
    if expect < 0.95:
        return "%-5.2f" % expect
    if expect < 9.5:
        return "%-5.1f" % expect
    return "%5.0f" % expect


def format_expect_nospace(expect: float) -> str:
    if expect < 1e-180:
        return "0.0"
    if expect < 9.5e-100:
        return "%.0e" % expect
    if expect < 0.0995:
        return "%.3f" % expect
    if expect < 0.95:
        return "%.2f" % expect
    if expect < 9.5:
        return "%.1f" % expect
    return "%.0f" % expect


def show_description(desc: str) -> str:
    """Query id = description up to the first space (hits.cc:1650-1658)."""
    sp = desc.find(" ")
    return desc if sp < 0 else desc[:sp]


def render_header(deflines: list[str], indent: int = 0, maxlen: int = 0,
                  linelen: int = LONG_MAX, maxdeflines: int = 1,
                  show_descr: bool = True) -> str:
    """Defline rendering mirroring show_deflines (asnparse.cc:889-971).

    maxlen>0 truncates with '...'; linelen<LONG_MAX pads/wraps to that
    width; maxdeflines>1 adds the '>' prefix, indentation and newlines.
    """
    out = []
    for x, defline in enumerate(deflines):
        if x >= maxdeflines:
            break
        show = len(defline)
        if maxlen and show > maxlen:
            show = maxlen
        if show < len(defline) and show >= 3:
            defline = defline[: show - 3] + "..."
        else:
            defline = defline[:show]
        pos = 0
        line = 0
        while pos < show:
            col = 0
            if maxdeflines > 1:
                if line:
                    out.append(" " * (1 + indent))
                    col = 1 + indent
                else:
                    out.append(" " if x else ">")
                    col = 1
            while pos < show and col < linelen:
                c = defline[pos]
                if not show_descr and c == " ":
                    pos = show
                else:
                    out.append(c)
                    pos += 1
                    col += 1
            if linelen < LONG_MAX:
                out.append(" " * (linelen - col))
            if maxdeflines > 1:
                out.append("\n")
            line += 1
    return "".join(out)


def defline_split(defline: str) -> tuple[int | None, str, str]:
    """hits_defline_split (hits.cc:1256-1287): (gi, link, title).

    Parses an optional leading ``gi|<n>|`` and splits the next token (the
    id chain) from the description.  Returns gi=None when no gi field is
    present — the reference's sscanf leaves the caller's variable
    UNTOUCHED then, and the ParAlign longVersion loop deliberately
    declares gi once per hit (hits.cc:1508), so a gi-less later defline
    reuses the previous defline's gi.
    """
    gi = None
    p = defline
    # sscanf("gi|%ld") skips whitespace after the literal and accepts a
    # sign (hits.cc:1268)
    mm = re.match(r"gi\|\s*([+-]?\d+)", p)
    if mm:
        gi = int(mm.group(1))
        p = p[mm.end():]
    if p.startswith("|"):
        p = p[1:]
    sp = p.find(" ")
    if sp >= 0:
        return gi, p[:sp], p[sp + 1:]
    return gi, "", p


def make_anchor(symtype: int, queryno: int, h: Hit) -> str:
    """make_anchor (hits.cc:1215-1254)."""
    qs = "-" if h.qstrand else "+"
    ds = "-" if h.dstrand else "+"
    if symtype == 0:
        return "%d_%d__%s__+" % (queryno, h.seqno, qs)
    if symtype == 2:
        return "%d_%d_%d_%s__" % (queryno, h.seqno, h.qframe + 1, qs)
    if symtype == 3:
        return "%d_%d___%d_%s" % (queryno, h.seqno, h.dframe + 1, ds)
    if symtype == 4:
        return "%d_%d_%d_%s_%d_%s" % (queryno, h.seqno, h.qframe + 1, qs,
                                      h.dframe + 1, ds)
    return "%d_%d____" % (queryno, h.seqno)


@dataclass
class ParalignInfo:
    """Context the -m 99 ParAlign XML renderer needs beyond the hit list
    (mirrors the globals hits_show_xml_paralign reads, hits.cc:1289-1648)."""

    queryname: str = ""
    databasename: str = ""
    matrixname: str = ""
    querystrands: int = 3
    gapopen: int = 11
    gapextend: int = 1
    minexpect: float = 0.0
    expect: float = 10.0
    maxmatches: int = 250
    alignments: int = 100
    threads: int = 1
    queryno: int = 0
    starttime: str = ""
    endtime: str = ""
    elapsed: float = 0.0
    speed: float = 0.0
    sw_count: int = 0
    # the reference's hits_init never resets the global ``totalhits``
    # (hits.cc:317 resets only ``obvious``), so in multi-query runs the
    # ParAlign XML totalCount accumulates across queries; the CLI passes
    # the running total of earlier queries here for byte parity
    totalhits_offset: int = 0


@dataclass
class AlignStats:
    identities: int = 0
    positives: int = 0
    indels: int = 0
    aligned: int = 0
    gaps: int = 0
    q_first: int = 0
    q_last: int = 0
    d_first: int = 0
    d_last: int = 0
    poswidth: int = 1
    qline: str = ""
    aline: str = ""
    dline: str = ""


def _ops_iter(alignment: str):
    for op, num in re.findall(r"([MDI])(\d+)", alignment):
        yield op, int(num)


_OP_M, _OP_D, _OP_I = ord("M"), ord("D"), ord("I")


def _ops_arrays(alignment: str) -> tuple[np.ndarray, np.ndarray]:
    """Decode a run-length op string into (op codes, run lengths)."""
    ops = re.findall(r"([MDI])(\d+)", alignment)
    if not ops:
        return (np.zeros(0, np.uint8), np.zeros(0, np.int64))
    opc = np.frombuffer("".join(o for o, _ in ops).encode("ascii"),
                        np.uint8)
    lns = np.array([int(n) for _, n in ops], dtype=np.int64)
    return opc, lns


def _expand_runs(opc: np.ndarray, lns: np.ndarray):
    """Per-display-column decode of an op-run list.

    Returns (col_op, qoff, doff): the op code of every aligned column,
    and the number of query / db residues consumed BEFORE each column —
    so column t pairs q_seq[q_start + qoff[t]] (when col_op != I) with
    d_seq[d_start + doff[t]] (when col_op != D).  This replaces the
    per-residue Python walk of the reference's count_align/whole_align
    (hits.cc:862-1010) with NumPy over the whole
    alignment — at -b 100 batch scale the scalar walk was a measured
    host-side cost of the align phase."""
    col_op = np.repeat(opc, lns)
    qadv = col_op != _OP_I
    dadv = col_op != _OP_D
    qoff = np.cumsum(qadv) - qadv
    doff = np.cumsum(dadv) - dadv
    return col_op, qoff, doff


def _sym_lut(sym: str) -> np.ndarray:
    return np.frombuffer(sym.encode("latin-1"), np.uint8)


class Reporter:
    """Renders one query's results in the chosen view."""

    def __init__(self, out, view: int, symtype: int, matrix,
                 query=None, show_gis: int = 0, show_taxid: int = 0):
        self.out = out
        self.view = view
        self.symtype = symtype
        self.matrix = np.asarray(matrix, dtype=np.int64).reshape(32, 32)
        self.query = query
        self.show_gis = show_gis
        self.show_taxid = show_taxid

    def _deflines_gis(self, h: Hit) -> list[str]:
        """Deflines re-rendered with gi numbers forced on: the reference
        passes show_gis=1 (not the -I flag) to the header parser for the
        TSV and ParAlign views (hits.cc:1751, 1444, 1512)."""
        from .io.asn1 import render_defline
        if h.defline_objs:
            return [render_defline(d, True, bool(self.show_taxid))
                    for d in h.defline_objs]
        return h.deflines or [h.header]

    # ---- alignment walking (count_align / whole_align) ----------------------

    def _seq_context(self, h: Hit):
        q = self.query
        if self.symtype == 0:
            sym = SYM_NCBI_NT16
            q_seq = q.nt[h.qstrand]
            q_len_nt = 0
            d_len_nt = h.dlennt
        elif self.symtype == 5:
            sym = SYM_SOUND
            q_seq = q.aa[0]
            q_len_nt = 0
            d_len_nt = 0
        else:
            sym = SYM_NCBI_AA
            q_seq = q.aa[3 * h.qstrand + h.qframe]
            q_len_nt = len(q.nt[0]) if q.nt[0] is not None else 0
            d_len_nt = h.dlennt
        return sym, q_seq, q_len_nt, d_len_nt

    def align_stats(self, h: Hit, build_lines: bool = False) -> AlignStats:
        st = AlignStats()
        sym, q_seq, q_len_nt, d_len_nt = self._seq_context(h)
        d_seq = np.asarray(h.dseq) if h.dseq is not None else None
        opc, lns = _ops_arrays(h.alignment)
        st.aligned = int(lns.sum())
        gapruns = opc != _OP_M
        st.gaps = int(gapruns.sum())
        st.indels = int(lns[gapruns].sum())
        if st.aligned:
            col_op, qoff, doff = _expand_runs(opc, lns)
            mcol = col_op == _OP_M
            qarr = np.asarray(q_seq)
            qsv = qarr[h.align_q_start + qoff[mcol]].astype(np.int64)
            dsv = d_seq[h.align_d_start + doff[mcol]].astype(np.int64)
            eq = qsv == dsv
            st.identities = int(eq.sum())
            st.positives = int((eq | (self.matrix[qsv, dsv] > 0)).sum())
            if build_lines:
                lut = _sym_lut(sym)
                T = st.aligned
                qline = np.full(T, ord("-"), np.uint8)
                aline = np.full(T, ord(" "), np.uint8)
                dline = np.full(T, ord("-"), np.uint8)
                qcols = col_op != _OP_I
                dcols = col_op != _OP_D
                qline[qcols] = lut[qarr[h.align_q_start + qoff[qcols]]]
                dline[dcols] = lut[d_seq[h.align_d_start + doff[dcols]]]
                # whole_align (hits.cc:925-940): '|' for identities in
                # every mode, unlike the plain pairwise display
                aline[mcol] = np.where(
                    eq, np.uint8(ord("|")),
                    np.where(self.matrix[qsv, dsv] > 0,
                             np.uint8(ord("+")), np.uint8(ord(" "))))
                st.qline = qline.tobytes().decode("latin-1")
                st.aline = aline.tobytes().decode("latin-1")
                st.dline = dline.tobytes().decode("latin-1")
        elif build_lines:
            st.qline = st.aline = st.dline = ""

        # display coordinates (count_align, hits.cc:1113-1175)
        q_first, q_last = h.align_q_start, h.align_q_end
        d_first, d_last = h.align_d_start, h.align_d_end
        q_len = len(q_seq)
        d_len = h.dlen
        if self.symtype == 0:
            if h.qstrand:
                q_first = q_len - 1 - q_first
                q_last = q_len - 1 - q_last
            if h.dstrand:
                d_first = d_len - 1 - d_first
                d_last = d_len - 1 - d_last
        if self.symtype in (2, 4):
            if h.qstrand:
                q_first = q_len_nt - 1 - 3 * q_first - h.qframe
                q_last = q_len_nt - 1 - 3 * q_last - h.qframe - 2
            else:
                q_first = 3 * q_first + h.qframe
                q_last = 3 * q_last + h.qframe + 2
        if self.symtype in (3, 4):
            if h.dstrand:
                d_first = d_len_nt - 1 - 3 * d_first - h.dframe
                d_last = d_len_nt - 1 - 3 * d_last - h.dframe - 2
            else:
                d_first = 3 * d_first + h.dframe
                d_last = 3 * d_last + h.dframe + 2
        st.q_first = q_first + 1
        st.q_last = q_last + 1
        st.d_first = d_first + 1
        st.d_last = d_last + 1
        maxpos = max(st.q_first, st.q_last, st.d_first, st.d_last)
        st.poswidth = 1
        while maxpos > 9:
            maxpos //= 10
            st.poswidth += 1
        return st

    # ---- 60-column pairwise rendering (putalignop / show_align) -------------

    def render_pairwise(self, h: Hit, poswidth: int) -> str:
        """show_align (hits.cc:757-813): query always from the plus-nt for
        blastn; coordinates remapped per strand/frame per 60-col block."""
        q = self.query
        if self.symtype == 0:
            sym = SYM_NCBI_NT16
            q_seq = q.nt[0]
            q_len_nt = 0
            d_len_nt = 0
        elif self.symtype == 5:
            sym = SYM_SOUND
            q_seq = q.aa[0]
            q_len_nt = 0
            d_len_nt = 0
        else:
            sym = SYM_NCBI_AA
            q_seq = q.aa[3 * h.qstrand + h.qframe]
            q_len_nt = len(q.nt[0]) if q.nt[0] is not None else 0
            d_len_nt = h.dlennt
        d_seq = h.dseq
        d_len = h.dlen

        out = []
        ALIGNLEN = 60
        opc, lns = _ops_arrays(h.alignment)
        T = int(lns.sum())
        if T == 0:
            return ""
        # whole-alignment character rows + per-column consumed counts in
        # NumPy (the scalar per-residue walk was a measured host cost at
        # -b 100 batch scale); the 60-column block loop below only does
        # the per-block coordinate remap + formatting
        col_op, qoff, doff = _expand_runs(opc, lns)
        mcol = col_op == _OP_M
        qcols = col_op != _OP_I
        dcols = col_op != _OP_D
        lut = _sym_lut(sym)
        qarr = np.asarray(q_seq)
        darr = np.asarray(d_seq)
        qline = np.full(T, ord("-"), np.uint8)
        aline = np.full(T, ord(" "), np.uint8)
        dline = np.full(T, ord("-"), np.uint8)
        qsv = qarr[h.align_q_start + qoff[mcol]].astype(np.int64)
        dsv = darr[h.align_d_start + doff[mcol]].astype(np.int64)
        qline[qcols] = lut[qarr[h.align_q_start + qoff[qcols]]]
        dline[dcols] = lut[darr[h.align_d_start + doff[dcols]]]
        eq = qsv == dsv
        if self.symtype == 0:
            aline[mcol] = np.where(eq, np.uint8(ord("|")),
                                   np.uint8(ord(" ")))
        else:
            aline[mcol] = np.where(
                eq, lut[qsv],
                np.where(self.matrix[qsv, dsv] > 0,
                         np.uint8(ord("+")), np.uint8(ord(" "))))
        # residues consumed after column t (exclusive prefix -> inclusive)
        qend = qoff + qcols
        dend = doff + dcols

        for c0 in range(0, T, ALIGNLEN):
            c1 = min(c0 + ALIGNLEN, T)
            q_start = h.align_q_start + int(qoff[c0])
            d_start = h.align_d_start + int(doff[c0])
            q_pos = h.align_q_start + int(qend[c1 - 1])
            d_pos = h.align_d_start + int(dend[c1 - 1])
            q1 = q_start + 1
            q2 = q_pos
            d1 = d_start + 1
            d2 = d_pos
            if self.symtype == 0 and h.dstrand:
                d1 = d_len - d1 + 1
                d2 = d_len - d2 + 1
            if self.symtype in (2, 4):
                if h.qstrand:
                    q1 = q_len_nt - 3 * q_start - h.qframe
                    q2 = q_len_nt - 3 * q_pos - h.qframe + 1
                else:
                    q1 = 3 * q_start + h.qframe + 1
                    q2 = 3 * q_pos + h.qframe
            if self.symtype in (3, 4):
                if h.dstrand:
                    d1 = d_len_nt - 3 * d_start - h.dframe
                    d2 = d_len_nt - 3 * d_pos - h.dframe + 1
                else:
                    d1 = 3 * d_start + h.dframe + 1
                    d2 = 3 * d_pos + h.dframe
            out.append("\n")
            out.append("Query: %*d %s %d\n" % (
                poswidth, q1,
                qline[c0:c1].tobytes().decode("latin-1"), q2))
            out.append("       %*s %s\n" % (
                poswidth, "", aline[c0:c1].tobytes().decode("latin-1")))
            out.append("Sbjct: %*d %s %d\n" % (
                poswidth, d1,
                dline[c0:c1].tobytes().decode("latin-1"), d2))
        return "".join(out)

    # ---- views ---------------------------------------------------------------

    def show_plain(self, hl: HitList) -> None:
        w = self.out.write
        if hl.count == 0:
            w("\nNo hits.\n")
            return
        ev = hl.evmodel
        if ev.available:
            w("                                                            "
              "     Score    E\n")
            w("Sequences producing significant alignments:                 "
              "     (bits) Value\n\n")
        else:
            w("Sequences producing significant alignments:                 "
              "        Score\n\n")
        for i in range(hl.showhits):
            h = hl.hits[i]
            headerlen = 67
            if self.symtype == 0:
                headerlen = 65
            elif self.symtype in (2, 3):
                headerlen = 64
            elif self.symtype == 4:
                headerlen = 61
            w(render_header(h.deflines or [h.header], 0, headerlen,
                headerlen, 1, True))
            if self.symtype == 0:
                w(" %c" % ("-" if h.dstrand else "+"))
            elif self.symtype == 2:
                w(" %c%d" % ("-" if h.qstrand else "+", h.qframe + 1))
            elif self.symtype == 3:
                w(" %c%d" % ("-" if h.dstrand else "+", h.dframe + 1))
            elif self.symtype == 4:
                w(" %c%d/%c%d" % ("-" if h.qstrand else "+", h.qframe + 1,
                                  "-" if h.dstrand else "+", h.dframe + 1))
            if ev.available:
                w(" %5d" % ev.bits_rounded(h.score))
                w("   ")
                w(format_expect(ev.evalue(h.score)))
            else:
                w(" %5d" % h.score)
            w("\n")

        for i in range(hl.showalignments):
            h = hl.hits[i]
            w("\n")
            w(render_header(h.deflines or [h.header], 10, 0, 79,
                LONG_MAX, True))
            if self.symtype in (3, 4):
                w("          Length = %d\n" % h.dlennt)
            else:
                w("          Length = %d\n" % h.dlen)
            w("\n")
            if ev.available:
                w(" Score = %.1f bits (%d), Expect = %s" %
                  (ev.bits(h.score), h.score,
                   format_expect(ev.evalue(h.score))))
            else:
                w(" Score = %d" % h.score)
            w("\n")
            st = self.align_stats(h)
            w(" Identities = %d/%d (%d%%)" %
              (st.identities, st.aligned,
               st.identities * 100 // st.aligned))
            if self.symtype > 0:
                w(", Positives = %d/%d (%d%%)" %
                  (st.positives, st.aligned,
                   st.positives * 100 // st.aligned))
            if st.indels:
                w(", Gaps = %d/%d (%d%%)" %
                  (st.indels, st.aligned, st.indels * 100 // st.aligned))
            w("\n")
            if self.symtype == 0:
                w(" Strand = %s\n" %
                  ("Plus / Minus" if h.dstrand else "Plus / Plus"))
            elif self.symtype == 2:
                w(" Frame = %c%d\n" % ("-" if h.qstrand else "+",
                                       h.qframe + 1))
            elif self.symtype == 3:
                w(" Frame = %c%d\n" % ("-" if h.dstrand else "+",
                                       h.dframe + 1))
            elif self.symtype == 4:
                w(" Frame = %c%d / %c%d\n" %
                  ("-" if h.qstrand else "+", h.qframe + 1,
                   "-" if h.dstrand else "+", h.dframe + 1))
            w(self.render_pairwise(h, st.poswidth))
            w("\n")

    def show_xml(self, hl: HitList) -> None:
        w = self.out.write
        w("<result>\n")
        w("  <general>\n")
        w("    <hitcount>%d</hitcount>\n" % hl.count)
        w("  </general>\n")
        w("  <hits>\n")
        for i in range(hl.showhits):
            h = hl.hits[i]
            w("    <hit>\n")
            w("      <hitno>%d</hitno>\n" % (i + 1))
            w("      <track>%d</track>\n" % h.seqno)
            w("      <query>%s</query>\n" %
              show_description(self.query.description))
            w("      <name>%s</name>\n" %
              render_header(h.deflines or [h.header], 0, 0, LONG_MAX, 1,
                            True))
            # KNOWN DEVIATION: for hits beyond -b the reference prints
            # uninitialized/stale memory here (hits.cc:560-567 sets dlen
            # only when i < opt_alignments, and hits_enter's struct moves
            # shuffle whatever the reused malloc block held).  We print
            # the true sequence length instead.
            w("      <len>%d</len>\n" % h.dlen)
            w("      <score>%d</score>\n" % h.score)
            if i < hl.showalignments:
                st = self.align_stats(h, build_lines=True)
                w("      <alignment>%s</alignment>\n" % h.alignment)
                w("      <qpos>%d,%d</qpos>\n" % (st.q_first, st.q_last))
                w("      <dpos>%d,%d</dpos>\n" % (st.d_first, st.d_last))
                w("      <qseq>%s</qseq>\n" % st.qline)
                w("      <aseq>%s</aseq>\n" % st.aline)
                w("      <dseq>%s</dseq>\n" % st.dline)
            w("    </hit>\n")
        w("  </hits>\n")
        w("</result>\n")

    def show_tsv(self, hl: HitList, comments: bool, databasename: str
                 ) -> None:
        w = self.out.write
        ev = hl.evmodel
        if comments:
            # (no compile stamp: the reference prints its __DATE__ here,
            # which golden comparisons treat as volatile)
            w("# %s - Compiled  - %s\n" % (PROGRAM, REFLINE1))
            w("# Query: %s\n" % self.query.description)
            w("# Database: %s\n" % databasename)
            if ev.available:
                w("# Fields: Query id, Subject id, % identity, alignment "
                  "length, mismatches, gap openings, q. start, q. end, "
                  "s. start, s. end, e-value, bit score\n")
            else:
                w("# Fields: Query id, Subject id, % identity, alignment "
                  "length, mismatches, gap openings, q. start, q. end, "
                  "s. start, s. end, score\n")
        for i in range(hl.showalignments):
            h = hl.hits[i]
            w(show_description(self.query.description))
            w("\t")
            w(render_header(self._deflines_gis(h), 0, 0, LONG_MAX, 1,
                False))
            st = self.align_stats(h)
            w("\t%.2f\t%d\t%d\t%d\t%d\t%d\t%d\t%d" %
              (100.0 * st.identities / st.aligned,
               st.aligned,
               st.aligned - st.identities - st.indels,
               st.gaps,
               st.q_first, st.q_last, st.d_first, st.d_last))
            if ev.available:
                expect = ev.evalue(h.score)
                w("\t%.2g" % expect)
                w("\t%.1f" % ev.bits(h.score))
            else:
                w("\t%d" % h.score)
            w("\n")

    def show_xml_paralign(self, hl: HitList, info: ParalignInfo) -> None:
        """hits_show_xml_paralign (hits.cc:1289-1648)."""
        w = self.out.write
        q = self.query
        ev = hl.evmodel
        st = self.symtype
        w("\t<paralignOutput>\n")

        if st in (1, 3):
            qseqtype, seq, sym = "Amino Acid", q.aa[0], SYM_NCBI_AA
        else:
            # the reference tests only symtype 1/3 here (hits.cc:1299), so
            # sound queries (symtype 5) land in the nucleotide branch with
            # an empty nt[0]
            nt = q.nt[0] if q.nt[0] is not None else np.empty(0, np.int8)
            qseqtype, seq, sym = "Nucleotide", nt, SYM_NCBI_NT16
        w("\t\t<queryInformation>\n")
        w("\t\t\t<queryFilename>./%s</queryFilename>\n" % info.queryname)
        w("\t\t\t<querySequencetype>%s</querySequencetype>\n" % qseqtype)
        w("\t\t\t<queryDescription>%s</queryDescription>\n" % q.description)
        w("\t\t\t<queryLength>%d</queryLength>\n" % len(seq))
        w("\t\t\t<querySequence>%s</querySequence>\n" %
          "".join(sym[c] for c in seq))
        w("\t\t</queryInformation>\n")

        db = hl.db
        if st in (0, 3, 4):
            dbseqtype, ncbidb, ncbiopt = "Nucleotide", "Nucleotide", "GenBank"
        else:
            dbseqtype, ncbidb, ncbiopt = "Amino Acid", "Protein", "GenPept"
        w("\t\t<databaseInformation>\n")
        w("\t\t\t<databaseFilename>%s</databaseFilename>\n" %
          info.databasename)
        w("\t\t\t<databaseSequencetype>%s</databaseSequencetype>\n" %
          dbseqtype)
        w("\t\t\t<databaseDescription>%s</databaseDescription>\n" % db.title)
        w("\t\t\t<databaseVersion>%d</databaseVersion>\n" %
          getattr(db, "version", 4))
        w("\t\t\t<databaseDate>%s</databaseDate>\n" % db.time_str)
        w("\t\t\t<residueCount>%d</residueCount>\n" % db.symcount_masked())
        w("\t\t\t<sequenceCount>%d</sequenceCount>\n" % db.seqcount_masked())
        w("\t\t\t<longestSequenceLength>%d</longestSequenceLength>\n" %
          db.longest())
        w("\t\t</databaseInformation>\n")

        strands = {1: "Plus", 2: "Minus", 3: "Both"}.get(info.querystrands,
                                                         "")
        w("\t\t<options>\n")
        w("\t\t\t<algorithm>Smith-Waterman</algorithm>\n")
        if st in (0, 2, 4):
            w("\t\t\t<queryStrands>%s</queryStrands>\n" % strands)
        w("\t\t\t<scoreMatrix>%s</scoreMatrix>\n" %
          ("NT" if st == 0 else info.matrixname))
        w("\t\t\t<gapPenalties>\n")
        w("\t\t\t\t<gapPenaltyOpen>%d</gapPenaltyOpen>\n" % info.gapopen)
        w("\t\t\t\t<gapPenaltyExtension>%d</gapPenaltyExtension>\n" %
          info.gapextend)
        lam = ev.lambda_ if ev.available else 0.0
        K = ev.K if ev.available else 0.0
        H = ev.H if ev.available else 0.0
        for kind in ("ungapped", "gapped"):
            w("\t\t\t\t<%s>\n" % kind)
            w("\t\t\t\t\t<%sLambda>%.4g</%sLambda>\n" % (kind, lam, kind))
            w("\t\t\t\t\t<%sKappa>%.4g</%sKappa>\n" % (kind, K, kind))
            w("\t\t\t\t\t<%sEta>%.4g</%sEta>\n" % (kind, H, kind))
            w("\t\t\t\t</%s>\n" % kind)
        w("\t\t\t</gapPenalties>\n")
        w("\t\t\t<expectRange>\n")
        w("\t\t\t\t<expectRangeFrom>%.2g</expectRangeFrom>\n" %
          info.minexpect)
        w("\t\t\t\t<expectRangeTo>%.2g</expectRangeTo>\n" % info.expect)
        w("\t\t\t</expectRange>\n")
        w("\t\t\t<displayLimits>\n")
        w("\t\t\t\t<hitLimit>%d</hitLimit>\n" % info.maxmatches)
        w("\t\t\t\t<alignmentLimit>%d</alignmentLimit>\n" % info.alignments)
        w("\t\t\t\t<subalignmentLimit>%d</subalignmentLimit>\n" % 1)
        w("\t\t\t</displayLimits>\n")
        w("\t\t\t<threads>%d</threads>\n" % info.threads)
        w("\t\t</options>\n")

        # (three tabs as in the reference, hits.cc:1404)
        w("\t\t\t<searchInformation>\n")
        w("\t\t\t\t<searchStarted>%s</searchStarted>\n" % info.starttime)
        w("\t\t\t\t<searchCompleted>%s</searchCompleted>\n" % info.endtime)
        w("\t\t\t\t<searchElapsedTime>%.2fs</searchElapsedTime>\n" %
          info.elapsed)
        w("\t\t\t\t<searchSpeed>%.3f GCUPS</searchSpeed>\n" %
          (info.speed / 1e9))
        w("\t\t\t\t<searchSWAlignments>\n")
        w("\t\t\t\t\t<SWAbsolute>%d</SWAbsolute>\n" % info.sw_count)
        w("\t\t\t\t\t<SWPercent>100</SWPercent>\n")
        w("\t\t\t\t</searchSWAlignments>\n")
        w("\t\t\t</searchInformation>\n")

        w("\t\t<resultInformation>\n")
        w("\t\t\t<resultHits>\n")
        w("\t\t\t\t<totalCount>%d</totalCount>\n"
          % (info.totalhits_offset + hl.totalhits))
        w("\t\t\t\t<obviousCount>%d</obviousCount>\n" % hl.obvious)
        w("\t\t\t\t<shownCount>%d</shownCount>\n" % hl.showhits)
        w("\t\t\t</resultHits>\n")
        w("\t\t\t<alignmentCount>%d</alignmentCount>\n" % hl.showalignments)
        w("\t\t</resultInformation>\n")

        def write_link(tag: str, pad: str, gi: int, link: str) -> None:
            base = ("http://www.ncbi.nlm.nih.gov/entrez/query.fcgi?cmd=")
            if gi:
                w("%s<%sLink>\n" % (pad, tag))
                w("%s\t<%sLinkDestination>%sRetrieve&amp;db=%s&amp;"
                  "list_uids=%d&amp;dopt=%s</%sLinkDestination>\n" %
                  (pad, tag, base, ncbidb, gi, ncbiopt, tag))
                w("%s\t<%sLinkText>gi|%d</%sLinkText>\n" % (pad, tag, gi,
                                                            tag))
                w("%s</%sLink>\n" % (pad, tag))
            w("%s<%sLink>\n" % (pad, tag))
            w("%s\t<%sLinkDestination>%sSearch&amp;db=%s&amp;term=%s&amp;"
              "doptcmdl=%s</%sLinkDestination>\n" %
              (pad, tag, base, ncbidb, link, ncbiopt, tag))
            w("%s\t<%sLinkText>%s</%sLinkText>\n" % (pad, tag, link, tag))
            w("%s</%sLink>\n" % (pad, tag))

        w("\t\t<shortVersionHits>\n")
        for i in range(hl.showhits):
            h = hl.hits[i]
            anchor = make_anchor(st, info.queryno, h)
            gi, link, title = defline_split(self._deflines_gis(h)[0])
            gi = gi or 0
            w("\t\t\t<shortVersionHit>\n")
            w("\t\t\t\t<shortVersionAnchor>%s</shortVersionAnchor>\n" %
              anchor)
            write_link("shortVersion", "\t\t\t\t", gi, link)
            w("\t\t\t\t<shortVersionName>%.35s</shortVersionName>\n" % title)
            if st == 0:
                w("\t\t\t\t<shortVersionStrand>%c</shortVersionStrand>\n" %
                  ("-" if h.qstrand else "+"))
            elif st == 2:
                w("\t\t\t\t<shortVersionFrame>%c%d</shortVersionFrame>\n" %
                  ("-" if h.qstrand else "+", h.qframe + 1))
            elif st == 3:
                w("\t\t\t\t<shortVersionFrame>%c%d</shortVersionFrame>\n" %
                  ("-" if h.dstrand else "+", h.dframe + 1))
            elif st == 4:
                w("\t\t\t\t<shortVersionFrame>%c%d/%c%d"
                  "</shortVersionFrame>\n" %
                  ("-" if h.qstrand else "+", h.qframe + 1,
                   "-" if h.dstrand else "+", h.dframe + 1))
            w("\t\t\t\t<shortVersionScore>%d</shortVersionScore>\n" %
              h.score)
            w("\t\t\t\t<shortVersionEValue>%.2g</shortVersionEValue>\n" %
              (ev.evalue(h.score) if ev.available else 0.0))
            w("\t\t\t</shortVersionHit>\n")
        w("\t\t</shortVersionHits>\n")

        if not hl.showalignments:
            w("\t</paralignOutput>\n")
            return
        w("\t\t<longVersionHits>\n")
        for i in range(hl.showalignments):
            h = hl.hits[i]
            anchor = make_anchor(st, info.queryno, h)
            w("\t\t\t<longVersionHit>\n")
            w("\t\t\t\t<longVersionAnchor>%s</longVersionAnchor>\n" % anchor)
            w("\t\t\t\t<linkContainer>\n")
            gi = 0
            for d in self._deflines_gis(h):
                gi_new, link, title = defline_split(d)
                if gi_new is not None:
                    gi = gi_new
                write_link("longVersion", "\t\t\t\t\t", gi, link)
                w("\t\t\t\t\t<longVersionName>%s</longVersionName>\n" %
                  title)
            w("\t\t\t\t</linkContainer>\n")
            if st == 0:
                w("\t\t\t\t<databaseSequenceLength>%d nt"
                  "</databaseSequenceLength>\n" % h.dlen)
            elif st in (3, 4):
                w("\t\t\t\t<databaseSequenceLength>%d nt"
                  "</databaseSequenceLength>\n" % h.dlennt)
            else:
                w("\t\t\t\t<databaseSequenceLength>%d aa"
                  "</databaseSequenceLength>\n" % h.dlen)
            if st == 0:
                w("\t\t\t\t<alignmentMatchLocation>%s"
                  "</alignmentMatchLocation>\n" %
                  ("Matches on complementary strands." if h.qstrand
                   else "Matches on same strands."))
            elif 2 <= st <= 4:
                w("\t\t\t\t<longVersionFrames>\n")
                if st in (2, 4):
                    w("\t\t\t\t\t<longVersionQueryFrame>\n")
                    w("\t\t\t\t\t\t<queryStrand>%c</queryStrand>\n" %
                      ("-" if h.qstrand else "+"))
                    w("\t\t\t\t\t\t<queryFrame>%d</queryFrame>\n" %
                      (h.qframe + 1))
                    w("\t\t\t\t\t</longVersionQueryFrame>\n")
                if st in (3, 4):
                    w("\t\t\t\t\t<longVersionDatabaseFrame>\n")
                    w("\t\t\t\t\t\t<databaseStrand>%c</databaseStrand>\n" %
                      ("-" if h.dstrand else "+"))
                    w("\t\t\t\t\t\t<databaseFrame>%d</databaseFrame>\n" %
                      (h.dframe + 1))
                    w("\t\t\t\t\t</longVersionDatabaseFrame>\n")
                w("\t\t\t\t</longVersionFrames>\n")

            stt = self.align_stats(h, build_lines=True)
            w("\t\t\t\t<alignment>\n")
            w("\t\t\t\t\t<subalignment>\n")
            w("\t\t\t\t\t\t<longVersionScore>%d</longVersionScore>\n" %
              h.score)
            w("\t\t\t\t\t\t<longVersionEValue>%.2g</longVersionEValue>\n" %
              (ev.evalue(h.score) if ev.available else 0.0))
            w("\t\t\t\t\t\t<identical>\n")
            w("\t\t\t\t\t\t\t<identicalNominator>%d</identicalNominator>\n"
              % stt.identities)
            w("\t\t\t\t\t\t\t<identicalDenominator>%d"
              "</identicalDenominator>\n" % stt.aligned)
            w("\t\t\t\t\t\t\t<identicalPercentage>%.1f"
              "</identicalPercentage>\n" %
              (100.0 * stt.identities / stt.aligned))
            w("\t\t\t\t\t\t</identical>\n")
            if st != 0:
                w("\t\t\t\t\t\t<positive>\n")
                w("\t\t\t\t\t\t\t<positiveNominator>%d"
                  "</positiveNominator>\n" % stt.positives)
                w("\t\t\t\t\t\t\t<positiveDenominator>%d"
                  "</positiveDenominator>\n" % stt.aligned)
                w("\t\t\t\t\t\t\t<positivePercentage>%.1f"
                  "</positivePercentage>\n" %
                  (100.0 * stt.positives / stt.aligned))
                w("\t\t\t\t\t\t</positive>\n")
            w("\t\t\t\t\t\t<indels>\n")
            w("\t\t\t\t\t\t\t<indelsNominator>%d</indelsNominator>\n" %
              stt.indels)
            w("\t\t\t\t\t\t\t<indelsDenominator>%d</indelsDenominator>\n" %
              stt.aligned)
            w("\t\t\t\t\t\t\t<indelsPercentage>%.1f</indelsPercentage>\n" %
              (100.0 * stt.indels / stt.aligned))
            w("\t\t\t\t\t\t</indels>\n")
            w("\t\t\t\t\t\t<gaps>%d</gaps>\n" % stt.gaps)
            w("\t\t\t\t\t\t<alignmentQuery>\n")
            w("\t\t\t\t\t\t\t<alignmentQueryStart>%d"
              "</alignmentQueryStart>\n" % stt.q_first)
            w("\t\t\t\t\t\t\t<alignmentQueryLine>%s</alignmentQueryLine>\n"
              % stt.qline)
            w("\t\t\t\t\t\t\t<alignmentQueryEnd>%d</alignmentQueryEnd>\n" %
              stt.q_last)
            w("\t\t\t\t\t\t</alignmentQuery>\n")
            w("\t\t\t\t\t\t<alignmentLine>%s</alignmentLine>\n" % stt.aline)
            w("\t\t\t\t\t\t<alignmentDatabase>\n")
            w("\t\t\t\t\t\t\t<alignmentDatabaseStart>%d"
              "</alignmentDatabaseStart>\n" % stt.d_first)
            w("\t\t\t\t\t\t\t<alignmentDatabaseLine>%s"
              "</alignmentDatabaseLine>\n" % stt.dline)
            w("\t\t\t\t\t\t\t<alignmentDatabaseEnd>%d"
              "</alignmentDatabaseEnd>\n" % stt.d_last)
            w("\t\t\t\t\t\t</alignmentDatabase>\n")
            w("\t\t\t\t\t</subalignment>\n")
            w("\t\t\t\t</alignment>\n")
            w("\t\t\t</longVersionHit>\n")
        w("\t\t</longVersionHits>\n")
        w("\t</paralignOutput>\n")

    def show(self, hl: HitList, databasename: str = "",
             paralign: ParalignInfo | None = None) -> None:
        with trace.span("report", view=self.view):
            if self.view == 0:
                self.show_plain(hl)
            elif self.view == 7:
                self.show_xml(hl)
            elif self.view in (8, 9):
                self.show_tsv(hl, self.view == 9, databasename)
            elif self.view == 99:
                self.show_xml_paralign(hl, paralign or ParalignInfo(
                    databasename=databasename))


def show_begin(out, view: int) -> None:
    """hits_show_begin (hits.cc:1947-1977)."""
    if view == 0:
        out.write("%s [%s]\n\n%s\n\n" % (PROGRAM, PROGRAM_TPU, REFLINE))
    elif view == 7:
        out.write('<?xml version="1.0"?>\n')
    elif view == 99:
        url1 = "http://www.w3.org/2001/XMLSchema-instance"
        url2 = "http://www.paralign.org/ParalignXML.xsd"
        out.write('<?xml version="1.0"?>\n')
        out.write('<ParalignXML xmlns:xsi="%s" '
                  'xsi:noNamespaceSchemaLocation="%s">\n' % (url1, url2))
        out.write("\t<programInformation>\n")
        out.write("\t\t<programName>swipe</programName>\n")
        out.write("\t\t<programVersion>%s</programVersion>\n" % PROGRAM)
        out.write("\t\t<programDescription>Smith-Waterman database searches "
                  "with inter-sequence SIMD parallelisation"
                  "</programDescription>\n")
        out.write("\t\t<articleReferences>\n")
        out.write("\t\t\t<reference>%s</reference>\n"
                  % REFLINE1.removeprefix("Reference: "))
        out.write("\t\t</articleReferences>\n")
        out.write("\t\t<license>SWIPE is available under the GNU Affero "
                  "General Public License, version 3</license>\n")
        out.write("\t</programInformation>\n")


def show_end(out, view: int) -> None:
    if view == 99:
        out.write("</ParalignXML>\n")
