"""Roofline share of the port's hand-written kernels in a traced window.

Which choice ran each scheduled call comes from the port's ``run``
spans (op, choice), its width from the ``decide`` span that preceded it
on the same thread. A call counts when its choice is one of the hand
kernel families (a variant name ending in ``_cuda``); its least time is
`work.gnn.roofline_s` of the call's FLOPs and bytes against the card's
published peaks. The kernels' device time is the window's summed time
of the operations whose names the table below lists. A composed
pipeline (``pipe[...]``) whose stages run hand kernels adds their time
but no work, so the share errs low, never high.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from bench import trace as trace_mod
from bench.work import gnn as work

# kernel family -> the names its CUDA kernels carry in the device trace
# (src/repro_torch/csrc/*.cu)
KERNEL_NAMES: Dict[str, Tuple[str, ...]] = {
    "spmm": ("spmm_rows_kernel", "spmm_merge_kernel", "spmm_merge_fixup_kernel"),
    "sddmm": ("sddmm_slots_kernel",),
    "attention": ("attention_chunks_kernel", "attention_combine_kernel"),
    "softmax": ("row_softmax_kernel",),
}


def is_hand(choice: str) -> bool:
    return choice.split("[", 1)[0].endswith("_cuda")


def scheduled_calls(spans: List[dict]) -> List[Tuple[str, int, str]]:
    """(op, f, choice) of every ``run`` span, in order."""
    last_f: Dict[Tuple, int] = {}
    out = []
    for s in spans:
        args = s.get("args") or {}
        if s["name"] == "decide" and "f" in args:
            last_f[(s.get("tid"), args.get("op"))] = int(args["f"])
        elif s["name"] == "run" and (s.get("tid"), args.get("op")) in last_f:
            out.append((args["op"], last_f[(s.get("tid"), args["op"])], args.get("choice", "")))
    return out


def share(reading, ops: Sequence[str], families: Sequence[str]) -> Optional[float]:
    """Percent: the summed least time of the window's hand-kernel calls
    of ``ops`` over the device time of the ``families``' kernels; None
    where no such call ran or the card's peaks are unknown."""
    if reading.peaks is None or reading.window.trace is None:
        return None
    bound = 0.0
    for op, f, choice in scheduled_calls(reading.window.spans):
        if op in ops and is_hand(choice):
            flops, nbytes = reading.work["call"](op, f)
            bound += work.roofline_s(flops, nbytes, reading.peaks["fp32_flops"],
                                     reading.peaks["hbm_bytes_per_s"])
    names = [n for fam in families for n in KERNEL_NAMES[fam]]
    device_s = trace_mod.matching_seconds(reading.window.trace, names)
    if bound == 0.0 or device_s == 0.0:
        return None
    return 100.0 * bound / device_s
