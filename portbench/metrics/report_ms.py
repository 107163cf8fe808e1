"""Milliseconds a query spends in ``Reporter.show`` (the plain view, -m 0):
the benchmark's host-clock span around each call, summed over the window
and divided by the queries served."""


def read(run):
    n = sum(r.queries for r in run.requests)
    return 1e3 * sum(r.report_s for r in run.requests) / n if n else None
