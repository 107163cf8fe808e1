"""Database dump (-N): reconstruct FASTA from any Database.

Port of ``swipe_tpu/io/dump.py`` (host only).

Parity target: db_show_fasta (database.cc:1483-1536) and
db_print_seq_map (:146-162): 80-column sequence lines; amino acids in the
aa symbol set, nucleotides uppercase; ``split`` emits one FASTA record per
defline, otherwise deflines are joined with " >".
"""

from __future__ import annotations

from ..alphabet import SYM_NCBI_AA, SYM_NCBI_NT16U, SYM_SOUND, decode

__all__ = ["dump_fasta"]


def _seq_lines(codes, sym: str) -> str:
    chars = decode(codes, sym)
    return "".join(chars[i:i + 80] + "\n" for i in range(0, len(chars), 80))


def dump_fasta(out, db, symtype: int, split_headers: bool = False) -> None:
    if symtype in (1, 2):
        sym = SYM_NCBI_AA
    elif symtype in (0, 3, 4):
        sym = SYM_NCBI_NT16U
    else:
        sym = SYM_SOUND
    from .asn1 import render_defline
    show_taxid = bool(getattr(db, "show_taxid", False))
    for seqno in range(db.seqcount()):
        # the reference dump loop (swipe.cc:2539-2545) visits EVERY
        # seqno and filters only per defline inside db_parse_header
        # (membership bits + taxid) — it never consults the .msk oid
        # bitmap the search phase uses, so neither do we; headers with
        # no passing defline print nothing.  show_gis is forced on
        # (db_show_fasta, database.cc:1504)
        deflines = [render_defline(d, True, show_taxid)
                    for d in db.get_defline_objects(seqno)]
        if not deflines:
            continue
        # strand 0 / frame 0 through the MODE's fetch path: for translated
        # dbs (tblastn/x) the reference dumps the frame-0 translation and
        # renders it through the nt16u map (db_print_seq,
        # database.cc:1443-1455 — aa codes >= 16 print '#')
        codes, _ = db.get_sequence(seqno, symtype, 0, 0)
        if split_headers:
            for d in deflines:
                out.write(">%s\n" % d)
                out.write(_seq_lines(codes, sym))
        else:
            out.write(" ".join(">" + d for d in deflines))
            out.write("\n")
            out.write(_seq_lines(codes, sym))
