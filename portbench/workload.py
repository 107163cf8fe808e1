"""The benchmark's inputs, made from the seed: a database, and a stream of
requests drawn by the one general traffic generator.

A configuration file names its database generator (a module of
``generators/`` with ``build``, ``query_lengths`` and ``queries``); a
traffic file is data only:

* ``batch``: queries a request hands to ``SearchEngine.search_batch``;
* ``length``: [lo, hi], the query lengths the mix keeps from the
  configuration's query model;
* ``pool``: that many lengths, at evenly spaced quantiles of the model
  between lo and hi, make one round; every seed gets the same rounds of
  lengths, each round in its own order, so a seed changes which
  residues are searched and not how much work a window holds;
* ``rounds``: rounds in the stream (a window that runs past them starts
  over at the first request);
* ``check``: queries of the window that the reference judges.
"""

from __future__ import annotations

import importlib.util
import os
from dataclasses import dataclass

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclass
class Corpus:
    """Database records as one flat ASCII array, and their headers."""

    flat: np.ndarray            # uint8 letters of every record, end to end
    starts: np.ndarray          # int64 offset of each record
    lens: np.ndarray            # int64 length of each record
    headers: list[bytes]
    kind: str                   # "aa" or "nt"

    @property
    def residues(self) -> int:
        return int(self.lens.sum())

    def record(self, i: int) -> np.ndarray:
        return self.flat[self.starts[i]: self.starts[i] + self.lens[i]]

    def fasta(self) -> bytes:
        parts = []
        blob = memoryview(self.flat)
        for h, s, n in zip(self.headers, self.starts.tolist(),
                           self.lens.tolist()):
            parts += (b">", h, b"\n", blob[s:s + n], b"\n")
        return b"".join(parts)


@dataclass
class Workload:
    corpus: Corpus
    queries: list[bytes]              # letters, in stream order

    def requests(self, batch: int) -> list[list[int]]:
        """Query indices of each request, in order."""
        return [list(range(i, i + batch))
                for i in range(0, len(self.queries) - batch + 1, batch)]


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` beside this file, imported by path."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('-', '_').replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# SWIPE's programs by symtype (-p 0-4); ``modes/<name>.py`` holds what
# the benchmark knows of each
PROGRAMS = ("blastn", "blastp", "blastx", "tblastn", "tblastx")


def load_mode(config: dict):
    """The mode module of the configuration's ``symtype``; raises where
    ``modes/`` has none, and where the configuration reads a genetic code
    other than 1, the only one that the harness hands the program and
    that the reference translates."""
    for k in ("query_gencode", "db_gencode"):
        if int(config.get(k, 1)) != 1:
            raise ValueError(f"{config['name']}: {k} {config[k]}; only "
                             f"genetic code 1 is run and judged")
    st = int(config["symtype"])
    name = PROGRAMS[st] if 0 <= st < len(PROGRAMS) else f"symtype{st}"
    if not os.path.exists(os.path.join(HERE, "modes", name + ".py")):
        raise ValueError(f"{config['name']}: symtype {st} ({name}) has no "
                         f"mode module modes/{name}.py")
    mod = load_module("modes", name)
    if mod.SYMTYPE != st:
        raise ValueError(f"modes/{name}.py is symtype {mod.SYMTYPE}, "
                         f"not {st}")
    return mod


def letters_lut(composition: dict[str, float], bits: int = 16) -> np.ndarray:
    """A table of 2**bits letters in which each letter's share is its
    composition share, rounded to 2**-bits by largest remainders; a
    uniform draw of an index is then a draw of a letter."""
    n = 1 << bits
    keys = list(composition)
    p = np.array([composition[k] for k in keys], dtype=np.float64)
    p = p / p.sum() * n
    counts = np.floor(p).astype(np.int64)
    short = n - int(counts.sum())
    counts[np.argsort(-(p - counts), kind="stable")[:short]] += 1
    return np.repeat(np.frombuffer("".join(keys).encode(), np.uint8), counts)


def draw(lut: np.ndarray, n: int, rng: np.random.Generator) -> np.ndarray:
    return lut[rng.integers(0, len(lut), size=n, dtype=np.uint32)]


def build(config: dict, traffic: dict, seed: int) -> Workload:
    """The cell's database and request stream for ``seed``."""
    rng = np.random.default_rng(seed)
    gen = load_module("generators", config["database"]["generator"])
    corpus = gen.build(config["database"], rng)
    lo, hi = traffic["length"]
    pool = np.asarray(gen.query_lengths(config, lo, hi, int(traffic["pool"])),
                      dtype=np.int64)
    rounds = [pool[rng.permutation(len(pool))]
              for _ in range(int(traffic["rounds"]))]
    return Workload(corpus, gen.queries(corpus, config, rounds, rng))
