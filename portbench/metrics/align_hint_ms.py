"""Milliseconds a query spends in the align phase's endpoint hints
(``hint_endpoints_grid``: the dense arrays built on the host, their
upload, the hint kernel K4 and the copy back): the program's
``align.hint`` spans in the traced window, over the queries served."""

from portbench import program_spans


def read(run):
    return program_spans.named_ms_per_query(run, "align.hint")
