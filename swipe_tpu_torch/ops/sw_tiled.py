"""Query-tiled segmented Smith-Waterman (K8).

Port of ``swipe_tpu/ops/sw_tiled.py``: the same contract as
``ops.sw_segmented.sw_scores_segmented`` with an int8 profile whose
QLEN is a multiple of 64 (the TPU kernel's tile, kept as the contract's
check).  On the card it runs K9's kernel (``csrc/segment.cu``
``segment_rows_kernel``, int8, on the band walker: a warp a (query,
lane), bands sized to the query; see ``ops.sw_segmented``): the TPU's
64-row tile is the TPU's layout, not part of the contract, so one CUDA
design serves both.  It needs gapopenextend >= gapextend.  CPU tensors
take the plain column loop shared with K9.
Unlike the TPU kernel, which leaves the segments no block names
unwritten, the port zeroes them as K9 does.  Launches count in
``trace.launched("swipe_segment_tiled")``.
"""

from __future__ import annotations

import torch

from .sw_segmented import (check_segment_args, segment_launch,
                           sw_scores_segmented_plain)

__all__ = ["TQ", "sw_scores_tiled"]

TQ = 64   # the contract's QLEN multiple (the TPU kernel's tile rows)


def sw_scores_tiled(qpt: torch.Tensor, db: torch.Tensor,
                    seg_ids: torch.Tensor, *, nsegs: int,
                    gapopenextend: int, gapextend: int) -> torch.Tensor:
    """sw_scores_segmented with an int8 profile of QLEN a multiple of TQ;
    raises ValueError otherwise (and on the card on a negative gap open
    penalty)."""
    dev = check_segment_args(qpt, db, seg_ids, nsegs, (torch.int8,))
    if qpt.shape[1] % TQ:
        raise ValueError(f"qlen {qpt.shape[1]} not a multiple of TQ={TQ}")
    kw = dict(nsegs=nsegs, gapopenextend=gapopenextend, gapextend=gapextend)
    if dev.type != "cuda":
        return sw_scores_segmented_plain(qpt, db, seg_ids, **kw)
    return segment_launch("swipe_segment_tiled", qpt, db, seg_ids, nsegs,
                          gapopenextend, gapextend)
