"""Command-line interface: flag-compatible with the reference SWIPE binary.

Port of ``swipe_tpu/cli.py``: ``python -m swipe_tpu_torch`` takes the
JAX package's flags and renders the same bytes.

Parity targets: args_init/args_usage/args_show (swipe.cc:649-1162), the
per-query loop main/work() (swipe.cc:2436-2611).

Extra capability over the reference: ``-d`` may point at a plain FASTA file
(auto-detected), not just a formatdb/makeblastdb database; ``--backend``
selects the route and the device: ``auto`` and ``stream`` run the stream
route's CUDA kernels on the card, ``pallas`` and ``pallas_v1`` the
segment-packed route's (the tiled and the untiled kernel);
``stream_interpret`` and ``lax`` run the stream route's plain PyTorch
versions on the CPU, ``pallas_interpret`` the segment route's.  (The JAX
package's ``lax`` runs its segment route; the hit lists are the same.)
"""

from __future__ import annotations

import os
import re
import sys

from .alphabet import GENCODE_NAMES
from .io.db import FastaDatabase
from .io.fasta import read_queries
from .pipeline import SearchEngine, SearchParams, SearchTimings
from .report import (LONG_MAX, PROGRAM, ParalignInfo, Reporter, show_begin,
                     show_end)
from .stats import get_prefs

SYMTYPE_NAMES = {"blastn": 0, "blastp": 1, "blastx": 2, "tblastn": 3,
                 "tblastx": 4, "sound": 5}
SYMTYPE_STRINGS = ["Nucleotide", "Amino acid", "Translated query",
                   "Translated database", "Both translated", "Sound"]
MAX_THREADS = 256

USAGE = """Usage: %s [OPTIONS]
  -h, --help                 show help
  -d, --db=FILE              sequence database base name (required)
  -i, --query=FILE           query sequence filename (stdin)
  -M, --matrix=NAME/FILE     score matrix name or filename (BLOSUM62)
  -q, --penalty=NUM          penalty for nucleotide mismatch (-3)
  -r, --reward=NUM           reward for nucleotide match (1)
  -G, --gapopen=NUM          gap open penalty (11)
  -E, --gapextend=NUM        gap extension penalty (1)
  -v, --num_descriptions=NUM sequence descriptions to show (250)
  -b, --num_alignments=NUM   sequence alignments to show (100)
  -e, --evalue=REAL          maximum expect value of sequences to show (10.0)
  -k, --minevalue=REAL       minimum expect value of sequences to show (0.0)
  -c, --min_score=NUM        minimum score of sequences to show (1)
  -u, --max_score=NUM        maximum score of sequences to show (inf.)
  -a, --num_threads=NUM      number of threads to use [1-%d] (1)
  -m, --outfmt=NUM           output format [0,7-9=plain,xml,tsv,tsv+] (0)
  -I, --show_gis             show gi numbers in results (no)
  -p, --symtype=NAME/NUM     symbol type/translation [0-4] (1)
  -S, --strand=NAME/NUM      query strands to search [1-3] (3)
  -Q, --query_gencode=NUM    query genetic code [1-23] (1)
  -D, --db_gencode=NUM       database genetic code [1-23] (1)
  -x, --taxidlist=FILE       taxid list filename (none)
  -N, --dump=NUM             dump database [0-2=no,yes,split headers] (0)
  -H, --show_taxid           show taxid etc in results (no)
  -o, --out=FILE             output file (stdout)
  -z, --dbsize=NUM           set effective database size (0)
"""


def _atol(val) -> int:
    """C atol semantics: parse a leading [+-]?digits prefix; anything
    without one is 0 (the reference then rejects the 0 in its range
    validation, e.g. 'Illegal symbol type.').  A trailing suffix is
    ignored, so '-p 1x' runs blastp exactly like the reference."""
    m = re.match(r"\s*[+-]?\d+", str(val)) if val is not None else None
    return int(m.group()) if m else 0


def _atof(val) -> float:
    """C atof semantics: leading float prefix (incl. exponent), 0.0 when
    none — '-e 0.1x' runs like the reference, never an argument error."""
    m = re.match(r"\s*[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?",
                 str(val)) if val is not None else None
    return float(m.group()) if m else 0.0


def fatal(msg: str):
    sys.stderr.write(msg + "\n")
    sys.exit(1)


class Args:
    def __init__(self):
        self.gapopen = 0
        self.gapextend = 0
        self.matrixname = ""
        self.queryname = "-"
        self.databasename = ""
        self.minscore = 1
        self.maxscore = LONG_MAX
        self.maxmatches = 250
        self.alignments = 100
        self.threads = 1
        self.view = 0
        self.symtype = 1
        self.show_gis = 0
        self.show_taxid = 0
        self.expect = 10.0
        self.minexpect = 0.0
        self.taxidfilename = None
        self.matchscore = 1
        self.mismatchscore = -3
        self.querystrands = 3
        self.query_gencode = 1
        self.db_gencode = 1
        self.subalignments = 1
        self.dump = 0
        self.effdbsize = 0
        self.outfile = None
        self.backend = "auto"
        self.batch = 1
        # multi-host runs (the JAX package's parallel.multihost): parsed,
        # not ported yet
        self.mh_procs = 1
        self.mh_rank = 0
        self.mh_coord = "localhost:12321"


def parse_args(argv: list[str]) -> Args:
    a = Args()
    # short opt -> (attr, converter); numeric converters follow C
    # atol/atof prefix semantics (swipe.cc:930-1010 converts every
    # numeric flag with atol/atof, so '-G 11x' parses as 11, never an
    # argument error)
    spec = {
        "a": ("threads", _atol), "b": ("alignments", _atol),
        "c": ("minscore", _atol), "d": ("databasename", str),
        "D": ("db_gencode", _atol), "e": ("expect", _atof),
        "E": ("gapextend", _atol), "G": ("gapopen", _atol),
        "i": ("queryname", str), "k": ("minexpect", _atof),
        "K": ("subalignments", _atol), "m": ("view", _atol),
        "M": ("matrixname", str), "N": ("dump", _atol),
        "o": ("outfile", str), "q": ("mismatchscore", _atol),
        "Q": ("query_gencode", _atol), "r": ("matchscore", _atol),
        "u": ("maxscore", _atol), "v": ("maxmatches", _atol),
        "x": ("taxidfilename", str), "z": ("effdbsize", _atol),
    }
    long_to_short = {
        "db": "d", "query": "i", "matrix": "M", "penalty": "q",
        "reward": "r", "gapopen": "G", "gapextend": "E", "strand": "S",
        "num_descriptions": "v", "num_alignments": "b", "min_score": "c",
        "max_score": "u", "evalue": "e", "minevalue": "k",
        "num_threads": "a", "outfmt": "m", "symtype": "p", "taxid": "x",
        "comp_based_stats": "C", "query_gencode": "Q", "db_gencode": "D",
        "filter": "F", "subalignments": "K", "dump": "N", "out": "o",
        "dbsize": "z", "show_gis": "I", "show_taxid": "H", "help": "h",
        "backend": "BACKEND", "batch": "BATCH",
        "mh-procs": "MHPROCS", "mh-rank": "MHRANK", "mh-coord": "MHCOORD",
    }
    i = 0
    args = argv
    def usage_exit():
        sys.stdout.write(USAGE % ("swipe", MAX_THREADS))
        sys.exit(1)

    def help_exit():
        # -h always routes through args_help (version header + reference
        # line + usage, swipe.cc:818-825), even from a combined token
        from .report import REFLINE
        sys.stdout.write(
            "%s [%s]\n\n%s\n\n" % (PROGRAM, "swipe-tpu", REFLINE))
        usage_exit()

    def next_val(opt):
        nonlocal i
        i += 1
        if i >= len(args):
            fatal(f"Missing argument for option {opt}")
        return args[i]

    while i < len(args):
        arg = args[i]
        if arg.startswith("--"):
            body = arg[2:]
            if "=" in body:
                name, val = body.split("=", 1)
            else:
                name, val = body, None
            short = long_to_short.get(name)
            if short is None:
                usage_exit()
            opt = short
            extended = ("BACKEND", "BATCH", "MHPROCS", "MHRANK", "MHCOORD")
            if opt not in ("I", "H", "h") + extended and val is None:
                val = next_val(arg)
            if opt in extended:
                v = val if val is not None else next_val(arg)
                if opt == "BACKEND":
                    a.backend = v
                elif opt == "BATCH":
                    a.batch = _atol(v)
                elif opt == "MHPROCS":
                    a.mh_procs = _atol(v)
                elif opt == "MHRANK":
                    a.mh_rank = _atol(v)
                else:
                    a.mh_coord = v
                i += 1
                continue
        elif arg.startswith("-") and len(arg) >= 2:
            opt = arg[1]
            val = arg[2:] or None
            # getopt semantics: no-argument flags may be combined (-IH);
            # the first option letter that takes an argument consumes the
            # rest of the token
            while opt in ("I", "H", "h") and val:
                if opt == "I":
                    a.show_gis = 1
                elif opt == "H":
                    a.show_taxid = 1
                else:
                    help_exit()
                opt, val = val[0], val[1:] or None
            if opt not in ("I", "H", "h") and val is None:
                val = next_val(arg)
        else:
            # GNU getopt_long permutes non-option arguments to the end
            # and the reference never looks at them (optind unchecked
            # after the loop, swipe.cc:930): stray positionals are
            # silently ignored, e.g. `swipe -d db query.fa`
            i += 1
            continue

        if opt == "h":
            help_exit()
        elif opt == "I":
            a.show_gis = 1
        elif opt == "H":
            a.show_taxid = 1
        elif opt == "S":
            a.querystrands = {"plus": 1, "minus": 2, "both": 3}.get(
                val, None) or _atol(val)
        elif opt == "p":
            a.symtype = SYMTYPE_NAMES.get(val, None)
            if a.symtype is None:
                a.symtype = _atol(val)
        elif opt == "C":
            if val.upper() != "F" and val != "0":
                fatal("Composition-based score adjustments not supported.")
        elif opt == "F":
            if len(val) != 0 and val.upper() != "F":
                fatal("Query sequence filtering not supported.")
        elif opt in spec:
            attr, conv = spec[opt]
            setattr(a, attr, conv(val))
        else:
            usage_exit()
        i += 1

    # defaults and interactions (swipe.cc:1088-1126)
    if a.symtype == 0:
        if a.gapopen == 0:
            a.gapopen = 5
        if a.gapextend == 0:
            a.gapextend = 2
    elif a.symtype < 5:
        if not a.matrixname:
            a.matrixname = "BLOSUM62"
        prefs = get_prefs(a.matrixname)
        if prefs:
            if a.gapopen == 0:
                a.gapopen = prefs[0]
            if a.gapextend == 0:
                a.gapextend = prefs[1]
        else:
            if a.gapopen == 0 and a.gapextend == 0:
                fatal("Unknown score matrix. Gap penalties must be "
                      "specified (-G and -E).")
    elif a.symtype == 5:
        if not a.matrixname:
            a.matrixname = "IDENTITY_5_1"
        if a.gapopen == 0:
            a.gapopen = 15
        if a.gapextend == 0:
            a.gapextend = 5

    # validation (swipe.cc:1128-1159)
    if a.effdbsize < 0:
        fatal("Illegal effective db size specified")
    if a.threads < 1 or a.threads > MAX_THREADS:
        fatal("Illegal number of threads specified")
    if not a.databasename:
        fatal("No database specified.")
    if a.view not in (0, 7, 8, 9, 99):
        fatal("Illegal view type.")
    if a.gapopen < 0 or a.gapextend < 0 or (a.gapopen + a.gapextend) < 1:
        fatal("Illegal gap penalties.")
    if a.symtype < 0 or a.symtype > 5:
        fatal("Illegal symbol type.")
    if a.querystrands < 1 or a.querystrands > 3:
        fatal("Illegal query strands specified.")
    if a.querystrands == 2 and a.symtype in (1, 3, 4):
        fatal("Illegal strand specified for protein query.")
    if a.query_gencode not in GENCODE_NAMES:
        fatal("Illegal query genetic code specified.")
    if a.db_gencode not in GENCODE_NAMES:
        fatal("Illegal database genetic code specified.")
    if a.dump < 0 or a.dump > 2:
        fatal("Illegal dump mode.")
    return a


def open_database(a: Args):
    """Open a BLAST database, falling back to FASTA auto-detection."""
    from .io import blastdb
    protein_family = a.symtype in (1, 2, 5)
    dbtype = "aa" if protein_family else "nt"
    exts = (".pal", ".pin") if protein_family else (".nal", ".nin")
    for ext in exts:
        if os.path.exists(a.databasename + ext):
            try:
                return blastdb.BlastDatabase(
                    a.databasename, dbtype, db_gencode=a.db_gencode,
                    taxid_file=a.taxidfilename, show_gis=bool(a.show_gis),
                    show_taxid=bool(a.show_taxid))
            except ValueError as e:
                # reader diagnostics carry the reference's exact fatal
                # texts (database.cc:545-570, 804, 851): bare message on
                # stderr + exit 1, not a Python traceback
                fatal(str(e))
    if os.path.exists(a.databasename):
        if a.taxidfilename:
            fatal("Taxid filtering (-x) requires a BLAST-format database.")
        return FastaDatabase(a.databasename,
                             "sound" if a.symtype == 5 else dbtype,
                             db_gencode=a.db_gencode,
                             # -a drives ingestion too (the reference's
                             # pthread pool covers db preprocessing,
                             # swipe.cc:804,1684-1699)
                             threads=a.threads)
    fatal("Cannot open database.")


def args_show(out, a: Args, db, query, engine) -> None:
    """Plain-view preamble (args_show, swipe.cc:665-782)."""
    if a.view != 0:
        return
    w = out.write
    w("Database file:     %s\n" % a.databasename)
    w("Database title:    %s\n" % db.title)
    w("Database time:     %s\n" % db.time_str)
    if db.is_masked():
        w("Database size:     %d residues in %d sequences\n"
          % (db.symcount_masked(), db.seqcount_masked()))
    else:
        w("Database size:     %d residues in %d sequences\n"
          % (db.symcount(), db.seqcount()))
    w("Longest db seq:    %d residues\n" % db.longest())
    if a.effdbsize > 0:
        # (sic) the reference misspells "Effective" here
        w("Effecive db size:  %d\n" % a.effdbsize)
    w("Query file name:   %s\n" % a.queryname)
    w("Query length:      %d residues\n" % query.length)
    desc = query.description
    # an empty description prints nothing (query_show's loop body never
    # runs for strlen 0, query.cc)
    for i in range(0, len(desc), 60):
        if i == 0:
            w("Query description: %-60.60s\n" % desc[i:i + 60])
        else:
            w("                   %-60.60s\n" % desc[i:i + 60])
    if a.symtype == 0:
        w("Query strands:     %s\n" %
          {1: "Plus", 2: "Minus", 3: "Plus and minus"}[a.querystrands])
        w("Score matrix:      %d/%d\n" % (a.matchscore, a.mismatchscore))
    else:
        w("Score matrix:      %s\n" % a.matrixname)
    w("Gap penalty:       %d+%dk\n" % (a.gapopen, a.gapextend))
    w("Max expect shown:  %-g\n" % a.expect)
    w("Min score shown:   %d\n" % a.minscore)
    w("Max matches shown: %d\n" % a.maxmatches)
    w("Alignments shown:  %d\n" % a.alignments)
    w("Show gi's:         %d\n" % a.show_gis)
    w("Show taxid's:      %d\n" % a.show_taxid)
    w("Threads:           %d\n" % a.threads)
    w("Symbol type:       %s\n" % SYMTYPE_STRINGS[a.symtype])
    if a.symtype in (2, 4):
        w("Query genetic code:%s (%d)\n"
          % (GENCODE_NAMES[a.query_gencode], a.query_gencode))
    if a.symtype in (3, 4):
        w("DB genetic code:   %s (%d)\n"
          % (GENCODE_NAMES[a.db_gencode], a.db_gencode))
    if a.taxidfilename:
        w("Taxid filename:    %s\n" % a.taxidfilename)
    w("\n")


def _fatal_on_internal_error(gen):
    """Render the align phase's deliberate RuntimeErrors (e.g. "Internal
    error in align function.", align.cc:156) as the reference's fatal():
    bare message on stderr, exit 1 — not a Python traceback."""
    while True:
        try:
            yield next(gen)
        except StopIteration:
            return
        except RuntimeError as e:
            fatal(str(e))


# --backend -> (the engine's backend, its device)
BACKENDS = {"auto": ("stream", None), "stream": ("stream", "cuda"),
            "stream_interpret": ("stream", "cpu"), "lax": ("stream", "cpu"),
            "pallas": ("pallas", "cuda"), "pallas_v1": ("pallas_v1", "cuda"),
            "pallas_interpret": ("pallas_v1", "cpu")}


def main(argv=None) -> int:
    from . import native
    native.tune_malloc()   # host phases allocate multi-GB numpy buffers
    a = parse_args(sys.argv[1:] if argv is None else argv)
    if a.backend not in BACKENDS:
        fatal(f"Unknown backend {a.backend} (one of "
              f"{', '.join(BACKENDS)}).")
    if a.mh_procs > 1:
        # join the multi-host job first; only rank 0 renders output
        # (every rank computes identical results)
        from .parallel.multihost import init_multihost
        init_multihost(a.mh_coord, a.mh_procs, a.mh_rank)
        if a.mh_rank != 0:
            a.outfile = os.devnull
    out = open(a.outfile, "w") if a.outfile else sys.stdout

    db = open_database(a)

    if a.dump:
        from .io.dump import dump_fasta
        dump_fasta(out, db, a.symtype, split_headers=(a.dump == 2))
        if a.outfile:
            out.close()
        return 0

    params = SearchParams(
        symtype=a.symtype, querystrands=a.querystrands,
        matrixname=a.matrixname, matchscore=a.matchscore,
        mismatchscore=a.mismatchscore, gapopen=a.gapopen,
        gapextend=a.gapextend, descriptions=a.maxmatches,
        alignments=a.alignments, minscore=a.minscore, maxscore=a.maxscore,
        expect=a.expect, minexpect=a.minexpect, effdbsize=a.effdbsize,
        query_gencode=a.query_gencode, db_gencode=a.db_gencode,
        threads=a.threads)

    if a.queryname != "-":
        # query_init fatals BEFORE any output when fopen fails (missing
        # or unreadable, query.cc:193-194).  fopen on a DIRECTORY
        # succeeds on Linux (reads then fail -> zero queries), so that
        # case runs like an empty query file
        try:
            open(a.queryname, encoding="latin-1").close()
        except IsADirectoryError:
            pass
        except OSError:
            fatal("Cannot open query file.")

    backend, device = BACKENDS[a.backend]
    if a.mh_procs > 1:
        from .parallel.multihost import MultiHostEngine
        # a CPU backend scores on the CPU, any other on every visible
        # CUDA device
        engine = MultiHostEngine(
            db, params, backend=a.backend,
            devices=[device] if device == "cpu" else None)
    else:
        engine = SearchEngine(db, params, device=device, backend=backend)

    show_begin(out, a.view)

    def batched_results():
        """(queryno, query, hits, timings) in input order; --batch N scores
        N queries per kernel pass (extension over the reference)."""
        pending = []

        def flush():
            if not pending:
                return
            timings = SearchTimings()
            hitlists = engine.search_batch([q for _, q in pending], timings)
            for (qno, q), hl in zip(pending, hitlists):
                yield qno, q, hl, timings
            pending.clear()

        for qno, q in enumerate(
                read_queries(a.queryname, a.symtype, a.querystrands,
                             a.query_gencode)):
            pending.append((qno, q))
            if len(pending) >= max(a.batch, 1):
                yield from flush()
        yield from flush()

    totalhits_seen = 0
    for queryno, query, hits, timings in _fatal_on_internal_error(
            batched_results()):
        args_show(out, a, db, query, engine)
        if a.view == 0:
            # hits_init warning (hits.cc:504-505), printed when statistics
            # are unavailable for the (matrix, gap) combination
            if not hits.evmodel.available:
                out.write("Statistical parameters are not available "
                          "for the scoring system specified.\n"
                          "Bit scores and E-values will not be "
                          "computed.\n\n")
            out.write("Searching...")
            out.flush()
            out.write("..............................................."
                      "done\n\n")
            out.write("Search started:    %s\n" % timings.starttime)
            out.write("Search completed:  %s\n" % timings.endtime)
            out.write("Elapsed:           %.2fs\n" % timings.elapsed)
            out.write("Speed:             %.3f GCUPS\n" %
                      (timings.speed / 1e9))
            out.write("\n")
        rep = Reporter(out, a.view, a.symtype, engine.matrix.matrix,
                       query=query, show_gis=a.show_gis,
                       show_taxid=a.show_taxid)
        paralign = None
        if a.view == 99:
            paralign = ParalignInfo(
                queryname=a.queryname, databasename=a.databasename,
                matrixname=a.matrixname, querystrands=a.querystrands,
                gapopen=a.gapopen, gapextend=a.gapextend,
                minexpect=a.minexpect, expect=a.expect,
                maxmatches=a.maxmatches, alignments=a.alignments,
                threads=a.threads, queryno=queryno,
                starttime=timings.starttime, endtime=timings.endtime,
                elapsed=timings.elapsed, speed=timings.speed,
                # per-query SW count even under --batch (the shared
                # timings' compute[7] is batch-wide): every unit is scored
                # once per (strand, frame) of this query
                sw_count=engine.unit_count
                * len(engine.query_frames(query)),
                totalhits_offset=totalhits_seen)
        totalhits_seen += hits.totalhits
        rep.show(hits, a.databasename, paralign=paralign)
    show_end(out, a.view)
    if a.outfile:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
