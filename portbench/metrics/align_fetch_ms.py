"""Milliseconds a query spends fetching its kept hits' deflines and
sequences and binning the shown ones (``HitList.align_prepare``): the
program's ``align.fetch`` spans in the traced window, over the queries
served."""

from portbench import program_spans


def read(run):
    return program_spans.named_ms_per_query(run, "align.fetch")
