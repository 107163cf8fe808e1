"""Hard inputs for the row-form kernels: the endpoint hints (K4,
``sw_hint_stream``) and the query-tile pass (K5, ``stream_tile_pass``),
which spread a query's rows over a warp in strips of 16 rows (8 for an
int32 matrix) and bands of 32 strips.

Shared by the CPU tests (the plain versions against the JAX package), the
card tests and ``chip_smoke.py`` (the kernels against their plain
versions).  Imports numpy only: the card's machine has no JAX.

* hint bins (``hint_bins``, ``hint_dense``): queries that end one row
  either side of a strip edge and of a band edge, inside a strip, over
  one band (the grid's 513-1024 rows) and over 1,100 rows (the per-bin
  route's), each with subjects that tie at several rows across a strip or
  band edge (a motif repeated in the query, the subject the motif three
  times), subjects holding the query's tail (its last real row feeds F
  and E into the PAD rows below it), low-complexity, random and empty
  subjects, and first-tracked-column masks, one of them just past the
  tail's end;
* tile queries (``tile_lengths``) that end one row into a tile, at and
  inside a strip, at a tile edge and not at all, and ``plant_windows``,
  which writes mutated copies of query windows across those edges into a
  packed chunk, so that alignments run through them;
* the plain-pack stream kernel's (K2) launches at its band edges
  (``STREAM_LENGTHS``: bands of 128, 256 and 512 rows laid from each
  query's end, two bands over 512 rows);
* the wavefront kernel's (K7) giants (``wavefront_case``): alignments
  whose halves sit either side of a long horizontal gap (a gap in the
  query) across slab edges and a segment cut, so that E crosses them;
  and three giants of unequal length (``wavefront_giants_case``) with
  alignments across the cuts of the pieces the engine's call walks them
  in, gaps inside the pieces' overlaps and across slab edges.
"""

from __future__ import annotations

import numpy as np

PAD = 31
STRIP = 16          # rows a thread, int8 matrix (8 for int32)
BAND = 512          # rows a warp, int8 matrix (256 for int32)

# hint query lengths: strip edges (one row either side), inside a strip,
# band edges, two bands (the grid), over 1,100 rows (hint_endpoints_many)
HINT_GRID_LENGTHS = (15, 16, 17, 40, 511, 512, 513, 700, 1024)
HINT_LONG_LENGTHS = (1100, 1537)
# the wide matrix's bands are 256 rows: 300 takes two
HINT_WIDE_LENGTHS = (255, 257, 300)
# hint cases: (query lengths, gap open, gap extension, scale of BLOSUM62);
# gap open plus extension over 128, and the scale of 100 that puts the
# matrix outside int8 (the hint kernel's wide instantiation)
HINT_CASES = {"grid": (HINT_GRID_LENGTHS, 11, 1, 1),
              "grid_gap_over_128": (HINT_GRID_LENGTHS, 150, 2, 1),
              "over_1100_rows": (HINT_LONG_LENGTHS, 11, 1, 1),
              "wide": (HINT_WIDE_LENGTHS, 1100, 100, 100)}
MOTIF = 7           # the period of a tie region (shorter in short queries)


def _tie_spans(qlen: int) -> list[tuple[int, int]]:
    """Rows [lo, hi) of the query where tie regions sit: around row 16,
    the band edge (512) and the query's last strip edge counted from its
    end (the hint kernel lays its bands from the query's end)."""
    spans = []
    for centre in (STRIP, BAND, qlen - STRIP):
        lo, hi = max(0, centre - 3 * MOTIF), min(qlen, centre + 3 * MOTIF)
        if hi - lo >= 8 and all(hi <= a or lo >= b for a, b in spans):
            spans.append((lo, hi))
    return spans


def hint_query(rng, qlen: int, alphabet=(1, 26)):
    """A query of ``qlen`` residues with a tie region (a motif repeated,
    at least four times) at each span of _tie_spans; returns (query,
    motifs)."""
    q = rng.integers(*alphabet, size=qlen, dtype=np.int8)
    motifs = []
    for lo, hi in _tie_spans(qlen):
        m = rng.integers(*alphabet, size=min(MOTIF, (hi - lo) // 4),
                         dtype=np.int8)
        q[lo:hi] = np.tile(m, -(-(hi - lo) // len(m)))[:hi - lo]
        motifs.append(m)
    return q, motifs


def hint_subjects(rng, q, motifs, nsub: int, maxlen: int,
                  alphabet=(1, 26)):
    """``nsub`` subjects of at most ``maxlen`` residues against query
    ``q``, cycling through the kinds: a motif three times (the query's
    region gives equal column maxima at rows MOTIF apart), the query's
    tail and then random residues, a low-complexity run, a mutated copy
    of a query window, random residues, and an empty subject.  Returns
    (subjects, tails): tails[i] is the column after subject i's copy of
    the query's tail, or -1."""
    subs, tails = [], []
    for k in range(nsub):
        kind = k % 6
        tail = -1
        if kind == 0 and motifs:
            s = np.tile(motifs[(k // 6) % len(motifs)], 3)
        elif kind == 1:
            n = min(len(q), 40, maxlen)
            s = np.concatenate([q[len(q) - n:], rng.integers(
                *alphabet, size=int(rng.integers(1, 30)), dtype=np.int8)])
            tail = n
        elif kind == 2:
            s = np.full(int(rng.integers(5, 200)), q[0], np.int8)
        elif kind == 3:
            a = int(rng.integers(0, max(1, len(q) - 20)))
            s = q[a:a + int(rng.integers(20, 400))].copy()
            flip = rng.random(len(s)) < 0.15
            s[flip] = rng.integers(*alphabet, size=int(flip.sum()),
                                   dtype=np.int8)
        elif kind == 4:
            s = rng.integers(*alphabet, size=int(rng.integers(1, maxlen)),
                             dtype=np.int8)
        else:
            s = np.zeros(0, np.int8)
        subs.append(s[:maxlen])
        tails.append(tail if tail <= maxlen else -1)
    return subs, tails


def hint_bins(rng, lengths, nsub: int, maxlen: int, alphabet=(1, 26)):
    """One bin a query length: [(query, subjects)] and each bin's tails
    (hint_subjects)."""
    bins, tails = [], []
    for n in lengths:
        q, motifs = hint_query(rng, n, alphabet)
        subs, t = hint_subjects(rng, q, motifs, nsub, maxlen, alphabet)
        bins.append((q, subs))
        tails.append(t)
    return bins, tails


def hint_starts(rng, bins, tails, lanes: int):
    """[nbins, lanes] int32 first tracked columns: zeros, but every
    seventh subject from a random column, and every second tail subject
    from the column just past its copy of the tail (the column max there
    is of the rows the tail fed, not of the copy)."""
    st = np.zeros((len(bins), lanes), np.int32)
    for b, (_, subs) in enumerate(bins):
        for i, s in enumerate(subs):
            if tails[b][i] >= 0 and i % 12 == 1:
                st[b, i] = tails[b][i]
            elif i % 7 == 3:
                st[b, i] = int(rng.integers(0, max(1, len(s))))
    return st


def hint_dense(bins, cols: int, lanes: int):
    """[nbins, cols, lanes] int8: bin b's subject i in lane (b, i),
    PAD-filled (the lanes past a bin's subjects are empty)."""
    db = np.full((len(bins), cols, lanes), PAD, np.int8)
    for b, (_, subs) in enumerate(bins):
        for i, s in enumerate(subs):
            db[b, :len(s), i] = s
    return db


def tile_lengths(tile_rows: int, strip: int = STRIP):
    """Query lengths for tile passes of ``tile_rows`` rows: one row into
    the fourth tile, one strip into the third (a strip edge), inside the
    third's second strip, one row short of a tile and a whole tile, and
    an empty slot (1,537, 1,040, 1,047, 511, 512, 0 at 512 rows)."""
    T = tile_rows
    return (3 * T + 1, 2 * T + strip, 2 * T + strip + 7, T - 1, T, 0)


def plant_windows(rng, data, start, queries, edges, width: int = 48,
                  per_edge: int = 4, flip: float = 0.1):
    """Write mutated copies of query windows across the rows ``edges``
    (each window's middle on the edge, cut at the query's ends) into a
    packed chunk ``data`` [L, NSEQS] int8 (changed in place), inside runs
    of real residues between start bits, so that the best alignments of
    those lanes run through the edges.  Returns the lanes written."""
    L, nseqs = data.shape
    blocks = np.asarray(start) != 0                 # [L / 16, NSEQS]
    done = []
    for q in queries:
        for e in edges:
            a = max(0, e - width // 2)
            w = q[a:a + width].copy()
            if not a < e < a + len(w):
                continue
            f = rng.random(len(w)) < flip
            w[f] = rng.integers(1, 26, size=int(f.sum()), dtype=np.int8)
            for _ in range(per_edge):
                for _try in range(200):
                    lane = int(rng.integers(0, nseqs))
                    c = int(rng.integers(0, L - len(w)))
                    run = data[c:c + len(w), lane]
                    b0, b1 = c // 16 + 1, (c + len(w) - 1) // 16 + 1
                    if lane in done or (run == PAD).any() \
                            or blocks[b0:b1, lane].any():
                        continue
                    data[c:c + len(w), lane] = w
                    done.append(lane)
                    break
    return done


# K2 launches, one a tuple of query lengths (qlen_pad: the longest
# rounded to 32): a band of 128 rows at 128, of 256 from 129 to 256, of
# 512 from 257 to 512, two bands of 512 over 512 rows; empty slots
STREAM_LENGTHS = ((128, 127, 1, 0), (129, 128, 64), (256, 255, 33),
                  (257, 256, 200), (511, 512, 16), (513, 1024, 700, 0))
# rows where K2's windows are planted: strip and band edges
STREAM_EDGES = (4, 8, 16, 128, 256, 512, 700)

# the wavefront cases' segment width (SEG_STRIPS = 4), and their giant
WAVE_SEGMENT = 4096


def rich_query(rng, n: int, symbols) -> np.ndarray:
    """A query of ``n`` residues drawn from ``symbols`` (those with the
    highest self-scores, so that each half of a gapped alignment
    outscores a long gap)."""
    return rng.choice(np.asarray(symbols, np.int8), size=n)


def plant_gapped(seq, q, split: int, gap_from: int, gap: int):
    """Write q[:split] into ``seq`` to end at column gap_from and
    q[split:] from column gap_from + gap: an alignment with a horizontal
    gap of ``gap`` columns over [gap_from, gap_from + gap)."""
    seq[gap_from - split:gap_from] = q[:split]
    seq[gap_from + gap:gap_from + gap + len(q) - split] = q[split:]


def wavefront_case(rng, symbols=None):
    """The card's K7 case: queries of 1,000, 600 and 40 rows (qlen_pad
    1024) against a giant of three WAVE_SEGMENT segments.  The first
    aligns with a gap of 1,100 columns over [3700, 4800) (the segment cut
    at 4096, the slab edges at 3840, 4096 and 4608 of 256- and 512-column
    slabs), the second with a gap of 700 over [8100, 8800) (the cut at
    8192, the edge at 8704), the third whole across the cut at 4096.
    ``symbols``: the query alphabet (default 1-25).  Returns (queries,
    giant)."""
    sym = np.arange(1, 26) if symbols is None else symbols
    qs = [rich_query(rng, 1000, sym), rich_query(rng, 600, sym),
          rich_query(rng, 40, sym)]
    seq = rng.integers(1, 26, size=3 * WAVE_SEGMENT, dtype=np.int8)
    plant_gapped(seq, qs[0], 500, 3700, 1100)
    plant_gapped(seq, qs[1], 300, 8100, 700)
    seq[4080:4120] = qs[2]
    return qs, seq


# the giants' case: their lengths, the queries' padded rows and the span
# bound V at those rows under BLOSUM62 11/1
WAVE_GIANTS = (70_000, 45_000, 30_500)
WAVE_GIANT_ROWS = 128
WAVE_GIANT_V = 12 * WAVE_GIANT_ROWS


def wavefront_giants_case(rng, cuts, symbols):
    """16 queries of up to WAVE_GIANT_ROWS residues (the first three of
    ``symbols``, the rest random) and giants of WAVE_GIANTS: at each
    (giant, column) of ``cuts`` (the first columns pieces own) the first
    query whole across the cut, the second with a gap of 300 columns up
    to 30 before it, the third with a gap of 900 inside the overlap
    before it; every 5 slabs from column 2,048 the second or third with a
    gap of 200 over the slab edge.  Returns (queries, giants)."""
    V = WAVE_GIANT_V
    qs = [rich_query(rng, n, symbols) for n in (128, 100, 64)]
    qs += [rng.integers(1, 26, size=int(n), dtype=np.int8)
           for n in rng.integers(1, WAVE_GIANT_ROWS + 1, size=13)]
    giants = [rng.integers(1, 26, size=n, dtype=np.int8)
              for n in WAVE_GIANTS]
    for g, seq in enumerate(giants):
        for edge in range(2048, len(seq) - 2048, 5 * 1024):
            plant_gapped(seq, qs[1 + g % 2], 40, edge - 10, 200)
    for g, b in cuts:
        seq = giants[g]
        seq[b - 64:b + 64] = qs[0]
        plant_gapped(seq, qs[1], 50, b - 30, 300)
        plant_gapped(seq, qs[2], 32, b - V + 100, 900)
    return qs, giants
