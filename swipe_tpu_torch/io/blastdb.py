"""NCBI BLAST v4 database reader.

Byte-compatible with the reference's reader (database.cc):
.pin/.phr/.psq (protein) and .nin/.nhr/.nsq (nucleotide) volumes
(db_open_xin :515-601), .pal/.nal alias files with DBLIST/OIDLIST/LENGTH/
NSEQ/MAXOID/MEMB_BIT and one level of nesting (db_read_alias :406-489,
db_open :775-925), .msk masked-subset bitmaps (db_check_msk :687-706),
taxid-list filtering (db_read_taxid_file :735-772), ncbi2na decompression
with ambiguity fixups (:1251-1323) and ASN.1 deflines (asnparse.cc).

Sequence files are memory-mapped; the index is parsed once with NumPy.
"""

from __future__ import annotations

import mmap
import os
import struct

import numpy as np

from ..alphabet import revcompl
from .asn1 import parse_defline_set, render_defline
from .db import Database, translate_frame

__all__ = ["BlastDatabase"]

# 2-bit ncbi2na -> nt16 one-hot codes, built per byte (256 x 4)
_DECOMP = np.zeros((256, 4), dtype=np.int8)
for _b in range(256):
    for _i in range(4):
        _DECOMP[_b, _i] = 1 << ((_b >> ((3 - _i) << 1)) & 3)


class _Volume:
    def __init__(self, basename: str, protein: bool):
        ext = "p" if protein else "n"
        self.basename = basename
        # the reference opens and maps all three files BEFORE parsing
        # the index (db_open_xin, database.cc:543-570), so failure
        # messages — and their order under combined corruption — must
        # match exactly: missing .xin, then an unmappable (empty) .xin,
        # then missing .xhr, then missing .xsq (whose fatal format
        # carries a trailing newline in the reference), then the
        # version check
        name_in = f"{basename}.{ext}in"
        try:
            with open(name_in, "rb") as f:
                idx = f.read()
        except OSError:
            raise ValueError("Unable to open file %s." % name_in)
        if not idx:
            raise ValueError("Unable to map file %s in memory. It may be "
                             "empty or too large." % name_in)
        for suffix in ("hr", "sq"):
            name = f"{basename}.{ext}{suffix}"
            if not os.path.exists(name):
                raise ValueError("Unable to open file %s." % name +
                                 ("\n" if suffix == "sq" else ""))
        pos = 0
        self.version, self.dbtype = struct.unpack_from(">II", idx, pos)
        pos += 8
        if self.version != 4:
            raise ValueError("Illegal database version (must be 4).")
        (tl,) = struct.unpack_from(">I", idx, pos)
        pos += 4
        self.title = idx[pos:pos + tl].decode("latin-1")
        pos += tl
        (dl,) = struct.unpack_from(">I", idx, pos)
        pos += 4
        self.time = idx[pos:pos + dl].decode("latin-1")
        pos += dl
        while pos & 3:
            pos += 1
        (self.seqcount,) = struct.unpack_from(">I", idx, pos)
        pos += 4
        (self.symcount,) = struct.unpack_from("<Q", idx, pos)
        pos += 8
        (self.longest,) = struct.unpack_from(">I", idx, pos)
        pos += 4
        n1 = self.seqcount + 1
        self.hdr_off = np.frombuffer(idx, dtype=">u4", count=n1,
                                     offset=pos).astype(np.int64)
        pos += 4 * n1
        self.seq_off = np.frombuffer(idx, dtype=">u4", count=n1,
                                     offset=pos).astype(np.int64)
        pos += 4 * n1
        if not protein:
            self.amb_off = np.frombuffer(idx, dtype=">u4", count=n1,
                                         offset=pos).astype(np.int64)
        else:
            self.amb_off = None

        self._fsq = open(f"{basename}.{ext}sq", "rb")
        self.seq_map = mmap.mmap(self._fsq.fileno(), 0,
                                 access=mmap.ACCESS_READ)
        self._fhr = open(f"{basename}.{ext}hr", "rb")
        self.hdr_size = os.path.getsize(f"{basename}.{ext}hr")
        self.hdr_map = (mmap.mmap(self._fhr.fileno(), 0,
                                  access=mmap.ACCESS_READ)
                        if self.hdr_size else b"")

        # masked-subset info (filled by the alias layer)
        self.msk = None
        self.masked_maxoid = 0
        self.masked_nseq = 0
        self.masked_length = 0


def _read_alias(path: str):
    """Parse a .pal/.nal alias file into a dict."""
    info = {"TITLE": None, "DBLIST": [], "OIDLIST": [], "LENGTH": 0,
            "NSEQ": 0, "MAXOID": 0, "MEMB_BIT": 0}
    with open(path) as f:
        for line in f:
            if line.startswith("TITLE "):
                # db_read_alias (database.cc:438-443) skips only LEADING
                # spaces/tabs and keeps everything up to CR/LF — trailing
                # whitespace is part of the title, byte for byte
                info["TITLE"] = line[6:].lstrip(" \t").rstrip("\r\n")
            elif line.startswith("DBLIST"):
                info["DBLIST"] = line[6:].split()
            elif line.startswith("OIDLIST"):
                info["OIDLIST"] = line[7:].split()
            elif line.startswith("GILIST"):
                raise ValueError(
                    "GILIST in database alias files not implemented.")
            elif line.startswith("LENGTH "):
                info["LENGTH"] = int(line[7:].strip())
            elif line.startswith("NSEQ "):
                info["NSEQ"] = int(line[5:].strip())
            elif line.startswith("MAXOID "):
                info["MAXOID"] = int(line[7:].strip())
            elif line.startswith("MEMB_BIT "):
                info["MEMB_BIT"] = int(line[9:].strip())
    return info


class BlastDatabase(Database):
    """Multi-volume BLAST v4 database with masking and taxid filtering.

    ``dbtype`` ('aa'/'nt') selects the extension family, mirroring the
    reference where the search symtype decides (p* for blastp/blastx,
    n* for blastn/tblastn/tblastx).
    """

    def __init__(self, basename: str, dbtype: str, db_gencode: int = 1,
                 taxid_file: str | None = None, show_gis: bool = False,
                 show_taxid: bool = False):
        protein = dbtype == "aa"
        self.dbtype = dbtype
        self.db_gencode = db_gencode
        self.show_gis = show_gis
        self.show_taxid = show_taxid
        self.volumes: list[_Volume] = []
        self.memb_bit = 0
        self._masked_seqcount = 0
        self._masked_symcount = 0

        path = os.path.dirname(basename)

        def addpath(name):
            return os.path.join(path, name) if path else name

        ext = "pal" if protein else "nal"
        alias_file = f"{basename}.{ext}"
        if os.path.exists(alias_file):
            ai = _read_alias(alias_file)
            self.title = ai["TITLE"] or basename
            self.memb_bit = ai["MEMB_BIT"]
            for i, name in enumerate(ai["DBLIST"]):
                base2 = addpath(name)
                alias2 = f"{base2}.{ext}"
                if os.path.exists(alias2):
                    ai2 = _read_alias(alias2)
                    if self.memb_bit and (len(ai2["OIDLIST"]) != 1
                                          or len(ai2["DBLIST"]) != 1):
                        raise ValueError("Illegal alias file (2).")
                    for j, name3 in enumerate(ai2["DBLIST"]):
                        v = _Volume(addpath(name3), protein)
                        if self.memb_bit:
                            self._open_msk(v, ai2, addpath(ai2["OIDLIST"][j]))
                        self.volumes.append(v)
                else:
                    if not ai["OIDLIST"]:
                        self.memb_bit = 0
                    if self.memb_bit and (len(ai["OIDLIST"]) != 1
                                          or len(ai["DBLIST"]) != 1):
                        raise ValueError("Illegal alias file (1).")
                    v = _Volume(base2, protein)
                    if self.memb_bit:
                        self._open_msk(v, ai, addpath(ai["OIDLIST"][i]))
                    self.volumes.append(v)
        else:
            v = _Volume(basename, protein)
            self.volumes.append(v)
            self.title = v.title

        self.time_str = self.volumes[0].time
        # db_open copies the first volume's format version to the main db
        # and -m 99 prints it (hits.cc:1340)
        self.version = self.volumes[0].version
        self._seqcount = sum(v.seqcount for v in self.volumes)
        self._symcount = sum(v.symcount for v in self.volumes)
        self._longest = max(v.longest for v in self.volumes)
        self._masked_seqcount += sum(v.masked_nseq for v in self.volumes)
        self._masked_symcount += sum(v.masked_length for v in self.volumes)
        if not self.memb_bit:
            self._masked_seqcount = self._seqcount
            self._masked_symcount = self._symcount
        self._vol_start = np.cumsum(
            [0] + [v.seqcount for v in self.volumes])

        self._taxid_bitmap = None
        if taxid_file:
            self._taxid_bitmap = self._read_taxid_file(taxid_file)

    def _open_msk(self, v: _Volume, ai: dict, mskfile: str) -> None:
        with open(mskfile, "rb") as f:
            v.msk = f.read()
        v.masked_maxoid = ai["MAXOID"]
        v.masked_nseq = ai["NSEQ"]
        v.masked_length = ai["LENGTH"]

    @staticmethod
    def _read_taxid_file(filename: str) -> np.ndarray:
        # fscanf("%lu\n") semantics (db_read_taxid_file,
        # database.cc:735-772): skip whitespace, read an optionally
        # signed integer, STOP SILENTLY at the first token that doesn't
        # start with one (a comment/header line ends the list, it does
        # not error); negatives wrap like strtoul
        import re as _re
        with open(filename) as f:
            text = f.read()
        taxids = []
        pos = 0
        while True:
            m = _re.match(r"\s*([+-]?\d+)", text[pos:])
            if not m:
                break
            taxids.append(int(m.group(1)) & ((1 << 64) - 1))
            pos += m.end()
        size = max((t // 8 for t in taxids), default=0) + 1
        size = max(size, 64 * 1024)
        bm = np.zeros(size, dtype=np.uint8)
        for t in taxids:
            bm[t // 8] |= np.uint8(1 << (t & 7))
        return bm

    def _check_taxid(self, taxid: int) -> bool:
        if self._taxid_bitmap is None:
            return True
        byteno = taxid // 8
        if byteno < len(self._taxid_bitmap):
            return bool((self._taxid_bitmap[byteno] >> (taxid & 7)) & 1)
        return False

    # ---- metadata -----------------------------------------------------------

    def seqcount(self) -> int:
        return int(self._seqcount)

    def symcount(self) -> int:
        return int(self._symcount)

    def longest(self) -> int:
        return int(self._longest)

    def is_masked(self) -> bool:
        return bool(self.memb_bit)

    def seqcount_masked(self) -> int:
        return int(self._masked_seqcount)

    def symcount_masked(self) -> int:
        return int(self._masked_symcount)

    # ---- volume resolution ----------------------------------------------------

    def _locate(self, seqno: int) -> tuple[_Volume, int]:
        vi = int(np.searchsorted(self._vol_start, seqno, side="right")) - 1
        if vi < 0 or vi >= len(self.volumes):
            raise IndexError("Cant find database volume.")
        return self.volumes[vi], seqno - int(self._vol_start[vi])

    # ---- inclusion ------------------------------------------------------------

    def _check_msk(self, seqno: int) -> bool:
        if not self.memb_bit:
            return True
        v, s = self._locate(seqno)
        if v.msk is None or s > v.masked_maxoid:
            return False
        byte = v.msk[4 + (s >> 3)]
        return bool((byte >> (7 - (s & 7))) & 1)

    def check_inclusion(self, seqno: int) -> bool:
        """db_check_inclusion (database.cc:1465-1481): the membership bit
        alone only tests the .msk oid bitmap; deflines are parsed during
        the scan ONLY when a taxid filter is active (db_check_taxid_seqno
        counts deflines passing both the taxid and membership filters)."""
        if not self._check_msk(seqno):
            return False
        if self._taxid_bitmap is not None:
            return len(self._deflines_filtered(seqno)) > 0
        return True

    # ---- sequences -------------------------------------------------------------

    def _raw_nt(self, seqno: int) -> np.ndarray:
        """Decompress one ncbi2na sequence to nt16 codes."""
        v, s = self._locate(seqno)
        off1 = int(v.seq_off[s])
        off2 = int(v.seq_off[s + 1])
        off3 = int(v.amb_off[s])
        aoff = off3 - off1
        data = np.frombuffer(v.seq_map, dtype=np.uint8, count=off2 - off1,
                             offset=off1)
        last = int(data[aoff - 1])
        nt_len = 4 * (aoff - 1) + (last & 3)
        out = _DECOMP[data[:aoff]].reshape(-1)[:nt_len].copy()
        # ambiguity corrections
        amb = data[aoff:]
        if len(amb) > 0:
            (count,) = struct.unpack_from(">I", amb, 0)
            if count >> 31:
                entries = np.frombuffer(amb, dtype=">u8",
                                        count=(len(amb) - 4) // 8, offset=4)
                vals = (entries >> 60).astype(np.int8)
                runs = ((entries >> 48) & 0xFFF).astype(np.int64) + 1
                offs = (entries & 0x0000FFFFFFFFFFF).astype(np.int64)
            else:
                entries = np.frombuffer(amb, dtype=">u4",
                                        count=(len(amb) - 4) // 4, offset=4)
                vals = (entries >> 28).astype(np.int8)
                runs = ((entries >> 24) & 0xF).astype(np.int64) + 1
                offs = (entries & 0x00FFFFFF).astype(np.int64)
            for val, run, off in zip(vals, runs, offs):
                out[off:off + run] = val
        return out

    def get_sequence(self, seqno: int, symtype: int, dstrand: int = 0,
                     dframe: int = 0) -> tuple[np.ndarray, int]:
        if self.dbtype == "aa":
            v, s = self._locate(seqno)
            off1 = int(v.seq_off[s])
            off2 = int(v.seq_off[s + 1])
            codes = np.frombuffer(v.seq_map, dtype=np.int8,
                                  count=off2 - off1 - 1, offset=off1)
            return codes, len(codes)
        nt = self._raw_nt(seqno)
        ntlen = len(nt)
        if symtype in (3, 4):
            return translate_frame(nt, dstrand, dframe, self.db_gencode), \
                ntlen
        if dstrand:
            return revcompl(nt), ntlen
        return nt, ntlen

    def get_length(self, seqno: int, symtype: int, dstrand: int = 0,
                   dframe: int = 0) -> tuple[int, int]:
        """Lengths straight from the volume offset tables (no decompress)."""
        v, s = self._locate(seqno)
        off1 = int(v.seq_off[s])
        off2 = int(v.seq_off[s + 1])
        if self.dbtype == "aa":
            n = off2 - off1 - 1
            return n, n
        aoff = int(v.amb_off[s]) - off1
        last = int(np.frombuffer(v.seq_map, dtype=np.uint8, count=1,
                                 offset=off1 + aoff - 1)[0])
        ntlen = 4 * (aoff - 1) + (last & 3)
        if symtype in (3, 4):
            return max((ntlen - dframe) // 3, 0), ntlen
        return ntlen, ntlen

    # ---- headers ---------------------------------------------------------------

    def _raw_header(self, seqno: int) -> bytes:
        v, s = self._locate(seqno)
        off1 = int(v.hdr_off[s])
        off2 = int(v.hdr_off[s + 1])
        return bytes(v.hdr_map[off1:off2])

    def _deflines_filtered(self, seqno: int) -> list:
        dls = parse_defline_set(self._raw_header(seqno))
        memb = self.memb_bit
        return [d for d in dls
                if self._check_taxid(d.taxid)
                and (d.memberships & memb) == memb]

    def get_deflines(self, seqno: int) -> list[str]:
        return [render_defline(d, self.show_gis, self.show_taxid)
                for d in self._deflines_filtered(seqno)]

    def get_defline_objects(self, seqno: int) -> list:
        return self._deflines_filtered(seqno)

    def get_header(self, seqno: int) -> str:
        dls = self.get_deflines(seqno)
        return dls[0] if dls else ""
