"""swipe-tpu on PyTorch and CUDA: exact Smith-Waterman database search on
an NVIDIA H100.

A port of the JAX package ``swipe_tpu`` (which stays the reference): the
same command line, packs, hit lists and report bytes, with the kernels of
the search path written by hand in CUDA C++ for sm_90a (``csrc/``):

  * the block score profiles of a lane-packed chunk (csrc/dprofile.cu);
  * the grouped stream scoring of NQ queries against every lane, its
    carry forms for flow and carry series and the query-tiled passes
    (csrc/carry_rows.cu);
  * the anti-diagonal wavefront over the giant sequences, in chains of
    slabs (csrc/wavefront.cu);
  * the alignment-endpoint hints of the align phase (csrc/hint.cu);
  * the segment-packed route's scoring (csrc/segment.cu) and the ALU-rate
    probe (csrc/peak.cu).

Each kernel has a plain PyTorch version beside it (ops/), which CPU
tensors take; the engine runs on CUDA
unless the caller passes ``device="cpu"``.  The package imports nothing of ``swipe_tpu`` or JAX.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy public API (keeps a bare import light)."""
    if name in ("SearchEngine", "SearchParams", "SearchTimings"):
        from . import pipeline
        return getattr(pipeline, name)
    if name in ("FastaDatabase",):
        from .io.db import FastaDatabase
        return FastaDatabase
    if name in ("BlastDatabase",):
        from .io.blastdb import BlastDatabase
        return BlastDatabase
    if name in ("read_queries", "preprocess_query"):
        from .io import fasta
        return getattr(fasta, name)
    if name in ("ScoreMatrix",):
        from .matrices import ScoreMatrix
        return ScoreMatrix
    raise AttributeError(name)
