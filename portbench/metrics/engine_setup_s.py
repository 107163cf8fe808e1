"""Seconds of the program's own set-up steps before the window: the
database's parse (``setup.db``), the scoring units (``setup.units``), the
packs (``setup.pack``) and their uploads (``setup.upload``), the
outermost of each nest, from the program's spans."""

from portbench import program_spans


def read(run):
    return program_spans.setup_seconds(run)
