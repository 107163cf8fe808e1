"""Milliseconds a query spends in the tracebacks of its shown hits
(``HitList.align_finish``): the program's ``align.traceback`` spans in the
traced window, over the queries served."""

from portbench import program_spans


def read(run):
    return program_spans.named_ms_per_query(run, "align.traceback")
