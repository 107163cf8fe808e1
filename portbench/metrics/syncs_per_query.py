"""Blocking device-to-host copies a query: the program's ``d2h_copies``
counter over the window's requests (the change its ``search`` spans
record), over the queries they served."""

from portbench import program_spans


def read(run):
    return program_spans.per_query_count(run, "d2h_copies")
