"""Query-tiled segmented Smith-Waterman (K8).

Port of ``swipe_tpu/ops/sw_tiled.py``: the same contract as
``ops.sw_segmented.sw_scores_segmented`` with an int8 profile whose
QLEN is a multiple of 64 (the TPU kernel's tile, kept as the contract's
check).  The CUDA kernel (``csrc/segment.cu`` ``tiled_kernel``) holds a
tile of query rows in registers and walks each block's 32 columns,
passing the tile's bottom row (its H and its F advanced into the next
tile) from tile to tile, so its row state is read and written once per
(tile, block).  CPU tensors take the plain column loop shared with K9.
Unlike the TPU kernel, which leaves the segments no block names
unwritten, the port zeroes them as K9 does.  Launches count in
``sw_scores_tiled.launches``.
"""

from __future__ import annotations

import torch

from . import sw_stream as _sw
from .sw_segmented import (check_segment_args, segment_launch,
                           sw_scores_segmented_plain)

__all__ = ["TQ", "sw_scores_tiled"]

TQ = 64   # the contract's QLEN multiple (the TPU kernel's tile rows)


def sw_scores_tiled(qpt: torch.Tensor, db: torch.Tensor,
                    seg_ids: torch.Tensor, *, nsegs: int,
                    gapopenextend: int, gapextend: int) -> torch.Tensor:
    """sw_scores_segmented with an int8 profile of QLEN a multiple of TQ;
    raises ValueError otherwise."""
    dev = check_segment_args(qpt, db, seg_ids, nsegs, (torch.int8,))
    if qpt.shape[1] % TQ:
        raise ValueError(f"qlen {qpt.shape[1]} not a multiple of TQ={TQ}")
    kw = dict(nsegs=nsegs, gapopenextend=gapopenextend, gapextend=gapextend)
    if dev.type != "cuda":
        return sw_scores_segmented_plain(qpt, db, seg_ids, **kw)
    return segment_launch("swipe_segment_tiled", qpt, db, seg_ids, nsegs,
                          gapopenextend, gapextend)


_sw._COUNTED["swipe_segment_tiled"] = sw_scores_tiled
sw_scores_tiled.launches = 0
