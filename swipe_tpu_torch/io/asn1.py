"""Binary ASN.1 (BER) Blast-def-line-set parser and encoder.

NCBI BLAST v4 header records (.phr/.nhr) hold one Blast-def-line-set per
sequence: a SEQUENCE OF Blast-def-line where each defline carries a title,
a list of Seq-ids (lcl/gi/gb/emb/sp/pdb/pat/gnl/...), a taxid, membership
bits and link bits.  All constructed values use indefinite length (0x80)
terminated by 00 00; strings are VisibleString (0x1A) with definite length;
integers are 0x02 big-endian.

Parser parity target: asnparse.cc (parse_blast_def_line_set,
parse_seq_id, parse_textseq_id, ...), including the exact defline rendering
("db|acc.ver|name" id forms joined with '|', " " + title, sp->tr for
unreviewed, optional |taxid|N / |link|N / |memb|N suffixes).

The encoder produces records the reference binary parses — it is the core
of the makeblastdb-equivalent writer (the JAX package's io/blastdb_writer.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["Defline", "parse_defline_set", "render_defline",
           "encode_defline", "encode_defline_set", "SEQID_DBS"]

SEQID_DBS = ["lcl", "bbs", "bbm", "gim", "gb", "emb", "pir", "sp", "pat",
             "ref", "gnl", "gi", "dbj", "prf", "pdb", "tpg", "tpe", "tpd",
             "gpp", "nat"]
_TEXTSEQ_TAGS = {0xA4, 0xA5, 0xA6, 0xA7, 0xA9, 0xAC, 0xAD, 0xAF, 0xB0,
                 0xB1, 0xB2, 0xB3}


@dataclass
class SeqId:
    kind: str                 # entry of SEQID_DBS
    # textseq ids
    name: str = ""
    accession: str = ""
    release: str = ""
    version: int = 0
    # integer ids (gi/bbs/bbm/gim)
    number: int = 0
    # object ids (lcl/gnl)
    id_string: str = ""
    id_integer: int = 0
    gnl_db: str = ""
    # pdb
    pdb_molid: str = ""
    pdb_chain: int = 32
    # patent
    pat_sequence: int = 0
    pat_country: str = ""
    pat_granted: int = 1
    pat_id: str = ""

    def render(self, show_gis: bool) -> str | None:
        """One id as the reference's show_* functions print it."""
        k = self.kind
        if k in ("bbs", "bbm", "gim"):
            return "%s|%d" % (k, self.number)
        if k == "gi":
            return "%s|%d" % (k, self.number) if show_gis else None
        if k == "lcl":
            if self.id_string:
                return "lcl|%s" % self.id_string
            return "lcl|%d" % self.id_integer
        if k == "gnl":
            if self.id_string:
                return "gnl|%s|%s" % (self.gnl_db, self.id_string)
            return "gnl|%s|%d" % (self.gnl_db, self.id_integer)
        if k == "pat":
            return "%s|%s|%s|%d" % ("pat" if self.pat_granted else "pgp",
                                    self.pat_country, self.pat_id,
                                    self.pat_sequence)
        if k == "pdb":
            if self.pdb_chain > 95:
                chain = chr(self.pdb_chain - 32) * 2
            else:
                chain = chr(self.pdb_chain)
            return "pdb|%s|%s" % (self.pdb_molid, chain)
        # textseq ids
        db = k
        if k == "sp" and self.release == "unreviewed":
            db = "tr"
        if self.version:
            return "%s|%s.%d|%s" % (db, self.accession, self.version,
                                    self.name)
        return "%s|%s|%s" % (db, self.accession, self.name)


@dataclass
class Defline:
    title: str = "unnamed protein product"
    seqids: list[SeqId] = field(default_factory=list)
    taxid: int = 0
    memberships: int = 0
    links: int = 0


def render_defline(d: Defline, show_gis: bool = False,
                   show_taxid: bool = False) -> str:
    """The display defline string (parse_blast_def_line, asnparse.cc:855-886)."""
    # a gi suppressed by show_gis contributes an EMPTY segment: the
    # reference appends "|" before every id once seqids is non-empty and
    # then concatenates the (empty) id (asnparse.cc:793-796), so
    # "sp|P1.1|NAM" + suppressed gi renders "sp|P1.1|NAM|"
    defline = ""
    for sid in d.seqids:
        r = sid.render(show_gis)
        if defline:
            defline += "|"
        defline += r or ""
    if show_taxid:
        if d.taxid:
            defline += "|taxid|%d" % d.taxid
        if d.links:
            defline += "|link|%d" % d.links
        if d.memberships:
            defline += "|memb|%d" % d.memberships
    if defline and d.title:
        defline += " "
    return defline + d.title


class _Parser:
    """Streaming BER parser with the reference's (obj, len, ch) cursor."""

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0
        self.ch = 0
        self.obj = 0
        self.len = 0
        self._nextch()
        self._nextobj()

    def _nextch(self):
        if self.pos < len(self.buf):
            self.ch = self.buf[self.pos]
            self.pos += 1
        else:
            self.ch = 0

    def _nextobj(self):
        self.obj = self.ch
        self._nextch()
        self.len = self.ch
        self._nextch()

    def match(self, tag: int):
        if self.obj != tag:
            raise ValueError(
                "Error parsing binary ASN.1 in database sequence "
                f"definition (got {self.obj:#x}, expected {tag:#x}).")
        self._nextobj()

    def integer(self) -> int:
        length = self.len
        if not (0 < length <= 4):
            raise ValueError("Illegal length of integer object.")
        v = 0
        for _ in range(length):
            v = (v << 8) | self.ch
            self._nextch()
        self._nextobj()
        return v

    def string(self) -> str:
        length = self.len
        if length in (0x81, 0x82, 0x83, 0x84):
            n = length - 0x80
            length = 0
            for _ in range(n):
                length = (length << 8) | self.ch
                self._nextch()
        elif length > 0x84:
            raise ValueError("Illegal string length.")
        out = bytearray()
        for _ in range(length):
            out.append(self.ch)
            self._nextch()
        self._nextobj()
        return out.decode("latin-1")

    # ---- grammar -------------------------------------------------------

    def object_id(self) -> tuple[int, str]:
        num, s = 0, ""
        if self.obj == 0xA0:
            self.match(0xA0)
            num = self.integer()
            self.match(0)
        elif self.obj == 0xA1:
            self.match(0xA1)
            s = self.string()
            self.match(0)
        return num, s

    def textseq_id(self, sid: SeqId):
        self.match(self.obj)  # inner SEQUENCE
        if self.obj == 0xA0:
            self.match(0xA0)
            sid.name = self.string()
            self.match(0)
        if self.obj == 0xA1:
            self.match(0xA1)
            sid.accession = self.string()
            self.match(0)
        if self.obj == 0xA2:
            self.match(0xA2)
            sid.release = self.string()
            self.match(0)
        if self.obj == 0xA3:
            self.match(0xA3)
            sid.version = self.integer()
            self.match(0)
        self.match(0)

    def date(self):
        tag = self.obj
        self.match(tag)
        if tag == 0xA0:
            self.string()
        elif tag == 0xA1:  # structured Date-std; skip fields
            self.match(0x30)
            self.match(0xA0)
            self.integer()
            self.match(0)
            for t in (0xA1, 0xA2):
                if self.obj == t:
                    self.match(t)
                    self.integer()
                    self.match(0)
            if self.obj == 0xA3:
                self.match(0xA3)
                self.string()
                self.match(0)
            for t in (0xA4, 0xA5, 0xA6):
                if self.obj == t:
                    self.match(t)
                    self.integer()
                    self.match(0)
            self.match(0)
        self.match(0)

    def seq_id(self) -> SeqId:
        tag = self.obj
        kind = SEQID_DBS[tag - 0xA0] if 0xA0 <= tag <= 0xB3 else "?"
        sid = SeqId(kind)
        self.match(tag)
        if tag in _TEXTSEQ_TAGS:
            self.textseq_id(sid)
        elif tag in (0xA1, 0xA2, 0xAB):
            sid.number = self.integer()
        elif tag == 0xA0:
            sid.id_integer, sid.id_string = self.object_id()
        elif tag == 0xA3:  # gim: Giimport-id
            self.match(0x30)
            self.match(0xA0)
            sid.number = self.integer()
            self.match(0)
            for t in (0xA1, 0xA2):
                if self.obj == t:
                    self.match(t)
                    self.string()
                    self.match(0)
            self.match(0)
        elif tag == 0xA8:  # pat: Patent-seq-id
            self.match(0x30)
            self.match(0xA0)
            sid.pat_sequence = self.integer()
            self.match(0)
            self.match(0xA1)
            # Id-pat
            self.match(0x30)
            self.match(0xA0)
            sid.pat_country = self.string()
            self.match(0)
            self.match(0xA1)
            if self.obj == 0xA0:
                self.match(0xA0)
                sid.pat_granted = 1
                sid.pat_id = self.string()
                self.match(0)
            elif self.obj == 0xA1:
                self.match(0xA1)
                sid.pat_granted = 0
                sid.pat_id = self.string()
                self.match(0)
            self.match(0)
            if self.obj == 0xA2:
                self.match(0xA2)
                self.string()
                self.match(0)
            self.match(0)
            self.match(0)
            self.match(0)
        elif tag == 0xAA:  # gnl: Dbtag
            self.match(0x30)
            self.match(0xA0)
            sid.gnl_db = self.string()
            self.match(0)
            self.match(0xA1)
            sid.id_integer, sid.id_string = self.object_id()
            self.match(0)
            self.match(0)
        elif tag == 0xAE:  # pdb: PDB-seq-id
            self.match(0x30)
            self.match(0xA0)
            sid.pdb_molid = self.string()
            self.match(0)
            if self.obj == 0xA1:
                self.match(0xA1)
                sid.pdb_chain = self.integer()
                self.match(0)
            if self.obj == 0xA2:
                self.match(0xA2)
                self.date()
                self.match(0)
            self.match(0)
        self.match(0)
        return sid

    def blast_def_line(self) -> Defline:
        self.match(0x30)
        if self.obj == 0x00:
            raise ValueError("Missing defline.")
        d = Defline()
        if self.obj == 0xA0:
            self.match(0xA0)
            d.title = self.string()
            self.match(0)
        if self.obj == 0xA1:
            self.match(0xA1)
            self.match(0x30)
            while self.obj:
                d.seqids.append(self.seq_id())
            self.match(0)
            self.match(0)
        if self.obj == 0xA2:
            self.match(0xA2)
            d.taxid = self.integer()
            self.match(0)
        if self.obj == 0xA3:
            self.match(0xA3)
            self.match(0x30)
            while self.obj:
                d.memberships = self.integer()
            self.match(0)
            self.match(0)
        if self.obj == 0xA4:
            self.match(0xA4)
            self.match(0x30)
            while self.obj:
                d.links = self.integer()
            self.match(0)
            self.match(0)
        if self.obj == 0xA5:
            self.match(0xA5)
            self.match(0x30)
            while self.obj:
                self.integer()
            self.match(0)
            self.match(0)
        self.match(0)
        return d


def parse_defline_set(buf: bytes) -> list[Defline]:
    p = _Parser(buf)
    p.match(0x30)
    out = []
    while p.obj:
        out.append(p.blast_def_line())
    return out


# ---- encoder ----------------------------------------------------------------


def _enc_string(s: str) -> bytes:
    b = s.encode("latin-1")
    n = len(b)
    if n < 0x80:
        hdr = bytes([0x1A, n])
    elif n < 0x100:
        hdr = bytes([0x1A, 0x81, n])
    elif n < 0x10000:
        hdr = bytes([0x1A, 0x82, n >> 8, n & 0xFF])
    else:
        hdr = bytes([0x1A, 0x83, n >> 16, (n >> 8) & 0xFF, n & 0xFF])
    return hdr + b


def _enc_int(v: int) -> bytes:
    if v < 0:
        raise ValueError(f"negative integers not encodable here: {v}")
    body = bytearray()
    x = v
    while True:
        body.insert(0, x & 0xFF)
        x >>= 8
        if x == 0:
            break
    if body[0] & 0x80:  # DER: keep value positive
        body.insert(0, 0)
    return bytes([0x02, len(body)]) + bytes(body)


def _ctx(tag: int, content: bytes) -> bytes:
    return bytes([tag, 0x80]) + content + b"\x00\x00"


def _enc_seqid(sid: SeqId) -> bytes:
    tag = 0xA0 + SEQID_DBS.index(sid.kind)
    if sid.kind == "lcl":
        if sid.id_string:
            inner = _ctx(0xA1, _enc_string(sid.id_string))
        else:
            inner = _ctx(0xA0, _enc_int(sid.id_integer))
        return _ctx(tag, inner)
    if sid.kind in ("gi", "bbs", "bbm"):
        return _ctx(tag, _enc_int(sid.number))
    if sid.kind == "gnl":
        if sid.id_string:
            oid = _ctx(0xA1, _enc_string(sid.id_string))
        else:
            oid = _ctx(0xA0, _enc_int(sid.id_integer))
        inner = _ctx(0x30, _ctx(0xA0, _enc_string(sid.gnl_db))
                     + _ctx(0xA1, oid))
        return _ctx(tag, inner)
    if sid.kind == "gim":
        # Giimport-id: SEQUENCE { id INTEGER } (asnparse.cc:367-380)
        return _ctx(tag, _ctx(0x30, _ctx(0xA0, _enc_int(sid.number))))
    if sid.kind == "pat":
        # Patent-seq-id { seqid INTEGER, cit Id-pat { country, id CHOICE
        # { number[A0] | app-number[A1] } } } (asnparse.cc:293-356)
        idpat = _ctx(0x30, _ctx(0xA0, _enc_string(sid.pat_country))
                     + _ctx(0xA1, _ctx(0xA0 if sid.pat_granted else 0xA1,
                                       _enc_string(sid.pat_id))))
        inner = _ctx(0xA0, _enc_int(sid.pat_sequence)) + _ctx(0xA1, idpat)
        return _ctx(tag, _ctx(0x30, inner))
    if sid.kind == "pdb":
        # PDB-seq-id { mol, chain INTEGER OPTIONAL } (asnparse.cc:590-617)
        return _ctx(tag, _ctx(0x30, _ctx(0xA0, _enc_string(sid.pdb_molid))
                              + _ctx(0xA1, _enc_int(sid.pdb_chain))))
    # textseq kinds
    fields = b""
    if sid.name:
        fields += _ctx(0xA0, _enc_string(sid.name))
    if sid.accession:
        fields += _ctx(0xA1, _enc_string(sid.accession))
    if sid.release:
        fields += _ctx(0xA2, _enc_string(sid.release))
    if sid.version:
        fields += _ctx(0xA3, _enc_int(sid.version))
    return _ctx(tag, _ctx(0x30, fields))


def encode_defline(d: Defline) -> bytes:
    content = _ctx(0xA0, _enc_string(d.title))
    if d.seqids:
        ids = b"".join(_enc_seqid(s) for s in d.seqids)
        content += _ctx(0xA1, _ctx(0x30, ids))
    if d.taxid:
        content += _ctx(0xA2, _enc_int(d.taxid))
    if d.memberships:
        content += _ctx(0xA3, _ctx(0x30, _enc_int(d.memberships)))
    if d.links:
        content += _ctx(0xA4, _ctx(0x30, _enc_int(d.links)))
    return _ctx(0x30, content)


def encode_defline_set(deflines: list[Defline]) -> bytes:
    return _ctx(0x30, b"".join(encode_defline(d) for d in deflines))
