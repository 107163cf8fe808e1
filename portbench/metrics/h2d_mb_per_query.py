"""Megabytes a query copied from the host to the card: the program's
``h2d_bytes`` counter over the window's requests (the change its
``search`` spans record), over the queries they served."""

from portbench import program_spans


def read(run):
    return program_spans.per_query_count(run, "h2d_bytes", 1e-6)
