"""The card's integer peak probe (K10): what the kernels' operation
bounds divide by.

Port of ``tools/mfu_stream.py`` ``measure_vpu_peak``: chains of
``x = max(x + 1, y); y = max(y - 1, x)`` with no memory traffic, timed
by slope between two iteration counts (fixed launch costs cancel).
``peak_chain`` runs ``csrc/peak.cu`` for CUDA tensors and its plain
version ``peak_chain_plain`` for CPU tensors, and counts its launches in
``trace.launched("swipe_peak")``.  ``measure_peak`` times the plain and
the DPX form (``__viaddmax_s32``) at 8 chains a thread on every SM
(issue-bound) and at one chain a thread, one warp an SM (latency-bound),
and reads the instructions each form compiled to from the SASS
(``cuobjdump``).
"""

from __future__ import annotations

import re
import subprocess
from collections import Counter

import torch

from .. import _build
from . import sw_stream as _sw

__all__ = ["PEAK_STEPS", "measure_peak", "peak_chain", "peak_chain_plain",
           "sass_opcodes"]

PEAK_STEPS = 64      # steps of every chain per loop iteration (peak.cu)
# the SASS opcodes of a chain's step: the add and max written out, or
# fused (the DPX add-max VIADDMNMX, or IMNMX forms)
CHAIN_OPCODES = ("IADD3", "IADD", "VIADD", "IMNMX", "VIMNMX", "VIADDMNMX")


def peak_chain_plain(x: torch.Tensor, steps: int, a: int = 1
                     ) -> torch.Tensor:
    """Plain version of peak_chain: ``steps`` steps of every chain."""
    y = x + a
    for _ in range(steps):
        x = torch.maximum(x + a, y)
        y = torch.maximum(y - a, x)
    return x + y


def peak_chain(x: torch.Tensor, iters: int, *, dpx: bool = False,
               block: int = 256) -> torch.Tensor:
    """x: [chains, threads] int32, chains 1 or 8, threads a multiple of
    ``block``; thread i runs the chains x[:, i] for iters * PEAK_STEPS
    steps (the DPX add-max with ``dpx``) and writes x + y.  Every form
    computes the same values."""
    dev = x.device
    _sw._check("x", x, torch.int32, 2, dev)
    chains, threads = x.shape
    if chains not in (1, 8) or threads % block:
        raise ValueError(f"peak_chain: {chains} chains x {threads} threads "
                         f"in blocks of {block}")
    if dev.type != "cuda":
        return peak_chain_plain(x, iters * PEAK_STEPS)
    out = torch.empty_like(x)
    _sw._launch("swipe_peak", dev, _sw._ptr(x), _sw._ptr(out), chains,
                int(dpx), threads, block, int(iters), 1)
    return out



def sass_opcodes() -> dict[str, Counter] | None:
    """Opcode counts of each peak kernel (peak_plain_1, peak_plain_8,
    peak_dpx_1, peak_dpx_8) in the built library's SASS, or None without
    cuobjdump."""
    tool = _build.cuda_tool("cuobjdump")
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", _build.kernel_library("peak")],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts: dict[str, Counter] = {}
    cur = None
    for line in sass.splitlines():
        m = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if m:
            cur = counts.setdefault(m.group(1), Counter())
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)",
                     line)
        if m and cur is not None:
            cur[m.group(1)] += 1
    return counts


def _slope_ms(fn, small: int, big: int, trials: int = 3) -> float:
    """Milliseconds per loop iteration: the least time of ``trials`` runs
    at two iteration counts, differenced (CUDA events)."""
    best = {}
    for n in (small, big):
        fn(n)                                   # warm
        ts = []
        for _ in range(trials):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn(n)
            b.record()
            torch.cuda.synchronize()
            ts.append(a.elapsed_time(b))
        best[n] = min(ts)
    return (best[big] - best[small]) / (big - small)


def measure_peak(device) -> dict:
    """The card's int32 and DPX add-max rates and its thread instruction
    issue rate, from the probe's slope; and each form's latency per
    dependent step at one chain a thread, one warp an SM.

    int32_ops_per_s counts two adds and two maxes a step (the TPU
    probe's count); dpx_ops_per_s counts DPX instructions (two a step);
    thread_instructions_per_s is the best of the two forms' SASS chain
    instructions (CHAIN_OPCODES) executed per second, or the DPX
    instruction rate where the SASS cannot be read."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    sass = sass_opcodes()
    out = {"sms": sms, "steps_per_iteration": PEAK_STEPS}
    per_s = {}
    for dpx in (False, True):
        form = "dpx" if dpx else "plain"
        # issue-bound: 8 chains a thread, 2048 threads on every SM
        x = torch.zeros((8, sms * 2048), dtype=torch.int32, device=device)
        ms = _slope_ms(lambda n: peak_chain(x, n, dpx=dpx), 20, 100)
        steps_per_s = x.numel() * PEAK_STEPS / (ms * 1e-3)
        # latency-bound: one chain a thread, one warp an SM
        x1 = torch.zeros((1, sms * 32), dtype=torch.int32, device=device)
        ms1 = _slope_ms(lambda n: peak_chain(x1, n, dpx=dpx, block=32),
                        500, 2500)
        per_step = None
        if sass is not None:
            ops = sum(sass[f"peak_{form}_8"][o] for o in CHAIN_OPCODES)
            per_step = ops / (8 * PEAK_STEPS)
            out[f"sass_{form}_8"] = dict(sass[f"peak_{form}_8"])
        out[f"{form}_chain_steps_per_s"] = steps_per_s
        out[f"{form}_sass_instructions_per_step"] = per_step
        out[f"{form}_latency_ns_per_step"] = ms1 * 1e6 / PEAK_STEPS
        if per_step is not None:
            per_s[form] = steps_per_s * per_step
        elif dpx:                 # one DPX instruction a line
            per_s[form] = steps_per_s * 2
    out["int32_ops_per_s"] = 4 * out["plain_chain_steps_per_s"]
    out["dpx_ops_per_s"] = 2 * out["dpx_chain_steps_per_s"]
    out["thread_instructions_per_s"] = max(per_s.values())
    return out
