"""The plain versions of the row-form kernels' wrappers on the hard inputs
of tests/torch_row_cases.py, against the JAX package, and the gap check
of their card path.

``sw_hint_stream_plain`` (K4) against the JAX package's NumPy hint pass
(``swipe_tpu.ops.align_hint._hint_batch``, the pass its CPU backend
runs), bin by bin with first-tracked-column masks: queries ending at and
around strip and band edges, over one band (the grid's) and over 1,100
rows (the per-bin route's), the int8 matrix at two gap costs and the
wide one at 255-300 rows.  Integer DP: exact.  (The tile pass's cases
are in test_torch_long.py and the interpret-mode hint kernel's in
test_torch_hint.py, beside the JAX shapes those files compile.)"""

import numpy as np
import pytest
import torch

import torch_row_cases as rc
from swipe_tpu.matrices import ScoreMatrix
from swipe_tpu.ops import align_hint as jah
from swipe_tpu_torch.ops import sw_stream as tsw


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions run many small ops: one intra-op thread is
    several times faster than a pool contended by other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _column_h(q, s, mat, Q, R, col):
    """H of every query row at subject column ``col`` (a plain DP)."""
    m = len(q)
    h = np.zeros(m + 1, np.int64)
    e = np.full(m + 1, -(1 << 30), np.int64)
    for j in range(col + 1):
        hn = np.zeros(m + 1, np.int64)
        f = -(1 << 30)
        e = np.maximum(e - R, h - Q)
        for i in range(1, m + 1):
            hn[i] = max(h[i - 1] + mat[q[i - 1], s[j]], e[i], f, 0)
            f = max(f - R, hn[i] - Q)
        h = hn
    return h[1:]


@pytest.mark.parametrize("case", list(rc.HINT_CASES))
def test_hint_plain_matches_jax_host_pass_on_hard_bins(case):
    lengths, go, ge, scale = rc.HINT_CASES[case]
    Q, R = go + ge, ge
    mat = ScoreMatrix.builtin("BLOSUM62", 11, 1).matrix.astype(np.int64) \
        * scale
    rng = np.random.default_rng(70 + len(case))
    bins, tails = rc.hint_bins(rng, lengths, nsub=30, maxlen=300)
    lanes = 32                          # two lanes past the subjects
    starts = rc.hint_starts(rng, bins, tails, lanes)
    cols = -(-max(len(s) for _, subs in bins for s in subs) // 16) * 16
    qc, ql = tsw.build_qcodes([q for q, _ in bins], max(lengths))
    m = (tsw.build_matrix_wide if scale > 1 else tsw.build_matrix8)(mat)
    S, bq, bp = (x.numpy() for x in tsw.sw_hint_stream(
        _t(qc), _t(ql), _t(m), _t(rc.hint_dense(bins, cols, lanes)),
        _t(starts), gapopenextend=Q, gapextend=R))
    ties = 0
    for b, (q, subs) in enumerate(bins):
        want = jah._hint_batch(q.astype(np.int64), subs, mat, Q, R,
                               starts[b, :len(subs)].astype(np.int64))
        got = [(int(S[b, i]), int(bq[b, i]), int(bp[b, i]))
               for i in range(len(subs))]
        assert got == want, (case, len(q))
        assert (S[b, len(subs):] == 0).all() \
            and (bq[b, len(subs):] == -1).all()       # the empty lanes
        # the motif subjects: the endpoint's column holds the max at
        # several rows, and the reported one is the smallest
        for i in range(0, len(subs), 6):
            if got[i][1] < 0:
                continue
            h = _column_h(q, subs[i], mat, Q, R, got[i][2])
            rows = np.flatnonzero(h == got[i][0])
            assert rows[0] == got[i][1]
            ties += len(rows) > 1 and rows[-1] // 16 > rows[0] // 16
    assert ties >= len(bins)            # ties across a strip edge
    assert (bq == -1).any() and (starts > 0).any()


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device: drives a wrapper down its
    card path without a card."""

    @property
    def device(self):
        return torch.device("cuda")


def _row_calls():
    """Each row-form wrapper with small valid arguments on the 'card'."""
    z = lambda *s, v=0: torch.full(s, v, dtype=torch.int32)  # noqa: E731
    qc, ql = z(2, 512, v=1), z(2, v=40)
    m8 = torch.zeros((32, 32), dtype=torch.int8)
    db = torch.ones((64, 32), dtype=torch.int8)
    st = torch.zeros((4, 32), dtype=torch.int8)
    bh, bf, out = z(2, 64, 32), z(2, 64, 32), z(2, 4, 32)
    h, e, s, bh0c = tsw.make_stream_state_long(2, 512, 32, 512)
    return {
        "sw_hint_stream": (tsw.sw_hint_stream, (
            qc, ql, m8, torch.ones((2, 64, 32), dtype=torch.int8),
            z(2, 32)), {}),
        "stream_tile_pass": (tsw.stream_tile_pass, (
            qc, ql, 0, m8, db, st, bh, bf, out), dict(tile_rows=512)),
        "stream_tile_carry_pass": (tsw.stream_tile_carry_pass, (
            qc, ql, 0, m8, db, st, bh, bf, out, h, e, s, bh0c),
            dict(tile_rows=512)),
        "sw_scores_stream_carry_rows": (tsw.sw_scores_stream_carry_rows, (
            qc, ql, m8, db, st, h, e, s), {}),
    }


@pytest.mark.parametrize("name", list(_row_calls()))
def test_row_kernels_check_gaps_on_card_path(monkeypatch, name):
    # the row-form kernels take F from H before its max with F, exact for
    # a gap open penalty >= 0: their card path raises for Q < R before it
    # launches; the plain version (the CPU) takes any gaps
    fn, args, kw = _row_calls()[name]

    def no_launch(*a):
        raise AssertionError("launched")

    monkeypatch.setattr(tsw, "_launch", no_launch)
    card = [a.as_subclass(_OnCard) if torch.is_tensor(a) else a
            for a in args]
    with pytest.raises(ValueError, match="negative gap open"):
        fn(*card, gapopenextend=1, gapextend=2, **kw)
    fn(*args, gapopenextend=1, gapextend=2, **kw)
