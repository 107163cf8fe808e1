"""The program's own scoring meter (``SearchTimings``, the reference
SWIPE's GCUPS: database residues times each query's strands and frames,
over the seconds from ``begin()`` to ``end_batch()``), summed over the
window: its cells over its seconds."""


def read(run):
    secs = sum(r.prog_scoring_s for r in run.requests)
    cells = sum(r.prog_cells for r in run.requests)
    return cells / secs / 1e9 if secs > 0 else None
