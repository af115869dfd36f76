"""host-sync: the hot loop must not wait on the device unannounced.

Between graph replays the port's decode is device-bound (ROADMAP "Where
the time goes"): each readback in the loop that paces the replays is a
host<->device round trip that serializes the host with the card, and a
stray one (a ``.item()`` in a finish check, a ``float()`` of a loss in a
log line) costs every step. The rule fires inside the hot set
(analysis/hotscope.py: the functions that replay a CUDA graph or drive
the training step, closed over their private helpers). Deliberate syncs
go through the blessed ``utils.tracecheck.host_sync`` (which this rule
recognises and the runtime ledger counts) or carry a reasoned
``# torchlint: disable=host-sync -- <why>``.
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from nanosandbox_tpu_torch.analysis.core import (Finding, ModuleContext,
                                                 Rule, register)
from nanosandbox_tpu_torch.analysis.hotscope import (TensorTracker,
                                                     dotted_name, walk_body)

# Methods that read a tensor back to the host.
_READBACK_METHODS = ("tolist", "cpu", "numpy")


def _is_blessed(name: str) -> bool:
    """utils.tracecheck APIs are the sanctioned way to sync and count."""
    return "tracecheck" in name or name.split(".")[-1] == "host_sync"


@register
class HostSyncRule(Rule):
    id = "host-sync"
    doc = (".item()/.tolist()/.cpu()/.numpy()/synchronize() and "
           "float()/int()/bool()/print() of a tensor in the functions "
           "that replay CUDA graphs or drive the training step")

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        idx = ctx.index
        out: List[Finding] = []
        for qual in sorted(idx.hot & set(idx.functions)):
            info = idx.functions[qual]
            tracker = TensorTracker(info, idx)
            where = f"a hot path driving graph replays or train steps ({qual})"
            for node in walk_body(info.node):
                if not isinstance(node, ast.Call):
                    continue
                name = dotted_name(node.func) or ""
                if name and _is_blessed(name):
                    continue
                func = node.func
                msg = None
                if isinstance(func, ast.Attribute) and not node.args:
                    if func.attr == "item":
                        msg = f".item() in {where} reads a tensor back"
                    elif func.attr == "synchronize":
                        msg = (f"{name or '.synchronize'}() in {where} "
                               "waits for the device")
                    elif (func.attr in _READBACK_METHODS
                          and tracker.is_tensor(func.value)):
                        msg = (f".{func.attr}() of a tensor in {where} "
                               "reads it back")
                elif name == "torch.cuda.synchronize":
                    msg = f"torch.cuda.synchronize() in {where}"
                elif (isinstance(func, ast.Name)
                      and func.id in ("float", "int", "bool")
                      and node.args and tracker.is_tensor(node.args[0])):
                    msg = (f"{func.id}() of a tensor in {where} reads it "
                           "back")
                elif (isinstance(func, ast.Name) and func.id == "print"
                      and any(tracker.is_tensor(a) for a in node.args)):
                    msg = f"print() of a tensor in {where} reads it back"
                if msg:
                    out.append(Finding(
                        ctx.path, node.lineno, node.col_offset, self.id,
                        msg + " (route deliberate syncs through "
                        "utils.tracecheck.host_sync)"))
        return out
