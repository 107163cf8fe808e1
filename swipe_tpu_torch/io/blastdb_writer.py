"""BLAST v4 database writer — the makeblastdb/formatdb equivalent.

Port of ``swipe_tpu/io/blastdb_writer.py`` (host only).

Produces .pin/.phr/.psq (protein) or .nin/.nhr/.nsq (nucleotide) volumes
that both this framework's reader and the reference SWIPE binary accept
(format derived from the reference reader, database.cc:
db_open_xin :515-601, sequence fetch :1237-1281, ambiguity fixups
:1284-1323).

Index (.pin/.nin) layout:
  u32be version=4 | u32be dbtype (1=protein, 0=nt) |
  u32be titlelen + title | u32be datelen + date | pad to 4-byte alignment |
  u32be seqcount | u64le symcount | u32be longest |
  (seqcount+1) x u32be header offsets |
  (seqcount+1) x u32be sequence offsets |
  [nt only] (seqcount+1) x u32be ambiguity offsets

Protein sequences (.psq): a leading NUL, then each sequence's aa codes
followed by a NUL.  Nucleotide sequences (.nsq): ncbi2na 2-bit packing
(A=0 C=1 G=2 T=3, big-endian within the byte), final byte carrying the
remainder bases and the remainder count in its low 2 bits, followed by an
ambiguity-correction section (u32be entry count with bit31 selecting the
64-bit entry format) rewriting ambiguous positions to their nt16 codes.
"""

from __future__ import annotations

import struct

import numpy as np

from .asn1 import Defline, SeqId, encode_defline_set

__all__ = ["write_blastdb", "make_deflines"]

# nt16 code -> 2-bit ncbi2na code for the unambiguous bases
_NT16_TO_2BIT = {1: 0, 2: 1, 4: 2, 8: 3}


def make_deflines(descriptions: list[str], parse_seqids: bool = False,
                  taxids: list[int] | None = None) -> list[list[Defline]]:
    """Build one title-only (or lcl-id) defline per FASTA description."""
    out = []
    for i, desc in enumerate(descriptions):
        d = Defline(title=desc if desc else "unnamed protein product")
        if parse_seqids and desc:
            first = desc.split(None, 1)
            rest = first[1] if len(first) > 1 else ""
            d = Defline(title=rest if rest else "unnamed protein product",
                        seqids=[SeqId("lcl", id_string=first[0])])
        if taxids is not None and taxids[i]:
            d.taxid = taxids[i]
        out.append([d])
    return out


def _pack_nt(codes: np.ndarray) -> tuple[bytes, bytes]:
    """Pack one nt16 sequence; returns (packed_bytes, ambiguity_section)."""
    n = len(codes)
    c = np.asarray(codes, dtype=np.int64)
    # vectorized nt16 -> 2-bit (ambiguous codes stored as A and fixed up
    # by the ambiguity section); a 16-entry LUT with -1 marking ambiguity
    lut = np.full(16, -1, dtype=np.int8)
    for k, v in _NT16_TO_2BIT.items():
        lut[k] = v
    mapped = lut[c]
    amb_pos = np.flatnonzero(mapped < 0)
    two_bit = np.where(mapped < 0, 0, mapped).astype(np.uint8)

    full = n // 4
    rem = n - 4 * full
    quads = two_bit[: 4 * full].reshape(-1, 4)
    pbytes = ((quads[:, 0] << 6) | (quads[:, 1] << 4) | (quads[:, 2] << 2)
              | quads[:, 3]).astype(np.uint8)
    # last byte: remainder bases in the high bits, count in the low 2 bits
    last = rem
    for k in range(rem):
        last |= int(two_bit[4 * full + k]) << (6 - 2 * k)
    packed = pbytes.tobytes() + bytes([last])

    # ambiguity section: run-length encode consecutive equal values
    entries: list[tuple[int, int, int]] = []  # (value, runlen, offset)
    if len(amb_pos):
        vals = c[amb_pos]
        brk = np.flatnonzero((np.diff(amb_pos) != 1)
                             | (np.diff(vals) != 0))
        starts = np.concatenate([[0], brk + 1])
        ends = np.concatenate([brk, [len(amb_pos) - 1]])
        for s0, e0 in zip(starts, ends):
            entries.append((int(vals[s0]), int(e0 - s0 + 1),
                            int(amb_pos[s0])))

    if not entries:
        return bytes(packed), b""

    big = n >= (1 << 24) or any(r > 16 for _, r, _ in entries)
    amb = bytearray()
    if big:
        # split runs longer than the 12-bit field
        out_entries = []
        for val, run, pos in entries:
            while run > 0:
                r = min(run, 1 << 12)
                out_entries.append((val, r, pos))
                pos += r
                run -= r
        amb += struct.pack(">I", (1 << 31) | len(out_entries) * 2)
        for val, run, pos in out_entries:
            e = (val << 60) | ((run - 1) << 48) | pos
            amb += struct.pack(">Q", e)
    else:
        amb += struct.pack(">I", len(entries))
        for val, run, pos in entries:
            e = (val << 28) | ((run - 1) << 24) | pos
            amb += struct.pack(">I", e)
    return bytes(packed), bytes(amb)


def write_blastdb(basename: str, seqs: list[np.ndarray],
                  deflines: list[list[Defline]], dbtype: str,
                  title: str = "", date: str = "Jan 1, 2026  12:00 AM"
                  ) -> None:
    """Write one BLAST v4 volume.

    seqs: encoded sequences — aa codes for dbtype 'aa', nt16 for 'nt'.
    deflines: per-sequence Blast-def-line lists.
    """
    protein = dbtype == "aa"
    ext = "p" if protein else "n"
    n = len(seqs)

    hdr_blobs = [encode_defline_set(ds) for ds in deflines]
    hdr_offsets = [0]
    for b in hdr_blobs:
        hdr_offsets.append(hdr_offsets[-1] + len(b))

    seq_blobs: list[bytes] = []
    amb_lens: list[int] = []
    if protein:
        start = 1  # leading NUL
        for s in seqs:
            seq_blobs.append(bytes(np.asarray(s, dtype=np.uint8)) + b"\x00")
            amb_lens.append(0)
    else:
        start = 0
        for s in seqs:
            packed, amb = _pack_nt(s)
            seq_blobs.append(packed + amb)
            amb_lens.append(len(amb))
    seq_offsets = [start]
    for b in seq_blobs:
        seq_offsets.append(seq_offsets[-1] + len(b))
    # ambiguity offsets point at each sequence's ambiguity section
    amb_offsets = [seq_offsets[i + 1] - amb_lens[i] for i in range(n)]
    amb_offsets.append(seq_offsets[n])

    longest = max((len(s) for s in seqs), default=0)
    symcount = sum(len(s) for s in seqs)

    with open(f"{basename}.{ext}hr", "wb") as f:
        for b in hdr_blobs:
            f.write(b)

    with open(f"{basename}.{ext}sq", "wb") as f:
        if protein:
            f.write(b"\x00")
        for b in seq_blobs:
            f.write(b)

    with open(f"{basename}.{ext}in", "wb") as f:
        title_b = title.encode()
        date_b = date.encode()
        head = struct.pack(">II", 4, 1 if protein else 0)
        head += struct.pack(">I", len(title_b)) + title_b
        head += struct.pack(">I", len(date_b)) + date_b
        while len(head) % 4:
            head += b"\x00"
        head += struct.pack(">I", n)
        head += struct.pack("<Q", symcount)   # total length: 64-bit LE
        head += struct.pack(">I", longest)
        f.write(head)
        f.write(struct.pack(">%dI" % (n + 1), *hdr_offsets))
        f.write(struct.pack(">%dI" % (n + 1), *seq_offsets))
        if not protein:
            f.write(struct.pack(">%dI" % (n + 1), *amb_offsets))
