"""The scoring work's least time on the card, over the device's busy time
inside the scoring spans, in percent.

Least time: the cells the inputs need (each query's residues, per strand
and frame, times each database residue; no padding), times the fewest
integer instructions one cell of the affine-gap recurrence needs, over
the card's highest published rate for any instruction.

* Instructions: h = max(diag + s, E, 0), h = max(h, F), best = max(best,
  h), t = h - (open + extend), E = max(E - extend, t), F = max(F -
  extend, t): 6 (the first and the last two as Hopper's DPX add-max).
  Packed 16-bit DPX instructions do two cells each, so 3 an exact cell.
* Rate: no H100 SM issues more than 4 warp instructions (128 lanes) a
  clock on any pipe; NVIDIA's H100 SXM5 data sheet gives 67 TFLOP/s
  FP32, 16,896 FP32 lanes x 2 FLOP x 1.98 GHz, hence 33.5e12 thread
  instructions a second.  The data sheet's rates assume its 700 W power
  limit; each run prints the card's limit beside its numbers.

Busy time: every kernel, copy and memset of the device trace inside the
benchmark's ``scoring`` spans (``SearchTimings.begin`` to ``end_batch``,
whose last step copies the reduced scores to the host), whichever kernel
does the work.  No exact implementation reads above 100%.
"""

INSTRUCTIONS_PER_CELL = 6 / 2
ISSUE_RATE = 67e12 / 2          # thread instructions a second
POWER_LIMIT_W = 700.0           # the data sheet's rates hold at this limit


def read(run):
    tl = run.timeline
    if tl is None:
        return None
    busy_ns = tl.busy_in("scoring")
    if busy_ns <= 0:
        return None
    cells = sum(r.cells for r in run.requests)
    least_s = cells * INSTRUCTIONS_PER_CELL / ISSUE_RATE
    return 100.0 * least_s / (busy_ns / 1e9)
