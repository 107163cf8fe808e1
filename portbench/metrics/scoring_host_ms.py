"""Milliseconds a query the host spends in the scoring phase other than
waiting for the card: the program's ``scoring`` spans in the traced
window less the ``sync`` spans inside them (the blocking copies back of
the chunk walk's results), over the queries served."""

from portbench import program_spans


def read(run):
    return program_spans.host_ms_per_query(run, "scoring")
