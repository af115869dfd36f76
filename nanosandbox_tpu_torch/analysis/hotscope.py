"""Hot-set index: which functions replay CUDA graphs or drive training.

The port's counterpart of the dispatcher half of the JAX package's
``analysis/jitscope.py``. The port traces no program, so there is no
traced set; what matters is the host code AROUND the device work, where
a readback serializes the host with the device:

  * ROOTS — functions that replay a captured CUDA graph (a call of
    ``<graph>.replay()``) or drive the training step (a call of one of
    KNOWN_STEPS, ``Trainer.train_step``);
  * CALLERS — the in-module functions that call a root, transitively
    (``Engine.step -> _step_impl -> _dispatch``): they pace the replays;
  * the HOT SET — roots and callers closed over the PRIVATE helpers they
    reference (``Engine._retire``, ``Engine._admit``): the loop's
    internals are underscore-named by convention; public siblings are
    setup code, not the loop.

Analysis is per-module and purely syntactic: no imports are resolved, no
types inferred. ``TensorTracker`` is the same spirit as JAX's
DeviceTracker: a value is a tensor when the source says so (the result
of a ``torch.*`` call, of a method of a tensor, an attribute the class
assigns from one; propagated through assignments and unpacking), and a
parameter counts once the body treats it like a tensor (``x.dtype``,
``x.float()``, ``x.detach()`` ...).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Set

# Calls that drive one training step (Trainer.train_step).
KNOWN_STEPS = {"train_step"}

# Attribute uses that mark a parameter as a tensor (evidence).
TENSOR_EVIDENCE_ATTRS = {
    "dtype", "device", "is_cuda", "float", "half", "bfloat16", "detach",
    "contiguous", "view", "masked_fill", "copy_", "zero_", "numel",
    "unsqueeze", "squeeze", "item", "tolist", "cpu", "numpy",
}

# Attribute reads of a tensor that are host facts, not tensors.
STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "size",
                "numel", "dim", "data_ptr", "element_size", "stride"}

# Methods whose result lives on the host (or is not a tensor at all).
HOST_METHODS = {"item", "tolist", "numpy"}

# torch.* namespaces whose results are not tensors.
_NON_TENSOR_TORCH = ("torch.cuda.", "torch.device", "torch.Generator",
                     "torch.no_grad", "torch.inference_mode",
                     "torch.get_num_threads", "torch.is_tensor",
                     "torch.finfo", "torch.iinfo", "torch.profiler.",
                     "torch.distributed.", "torch.backends.")


def dotted_name(node: ast.AST) -> Optional[str]:
    """'torch.cuda.synchronize' for Attribute/Name chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def terminal_name(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def walk_body(fn: ast.AST) -> Iterator[ast.AST]:
    """Walk a function's own statements, NOT nested def/class bodies
    (those are indexed as their own functions)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef, ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))


def _is_torch_tensor_call(name: str) -> bool:
    return (name.startswith("torch.")
            and not name.startswith(_NON_TENSOR_TORCH))


@dataclass
class FunctionInfo:
    qualname: str
    bare_name: str
    node: ast.AST
    parent_class: Optional[str] = None
    parent_fn: Optional[str] = None     # qualname of enclosing function
    params: List[str] = field(default_factory=list)


class ModuleIndex:
    """Per-module hot-set facts; built once, shared by every rule."""

    def __init__(self, tree: ast.Module):
        self.tree = tree
        self.functions: Dict[str, FunctionInfo] = {}
        self._by_bare: Dict[str, List[str]] = {}
        # class -> self attributes assigned from a torch tensor call
        self.tensor_attrs: Dict[str, Set[str]] = {}
        self._collect_functions(tree)
        self._collect_tensor_attrs()
        self.roots = self._find_roots()
        self.hot = self._close_hot()

    def _collect_functions(self, tree: ast.Module) -> None:
        def visit(node: ast.AST, cls: Optional[str], fn: Optional[str]):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    qual = f"{fn or cls}.{child.name}" if fn or cls \
                        else child.name
                    a = child.args
                    params = [x.arg for x in
                              (a.posonlyargs + a.args + a.kwonlyargs)]
                    info = FunctionInfo(qualname=qual, bare_name=child.name,
                                        node=child, parent_class=cls,
                                        parent_fn=fn, params=params)
                    self.functions[qual] = info
                    self._by_bare.setdefault(child.name, []).append(qual)
                    visit(child, cls, qual)
                elif isinstance(child, ast.ClassDef):
                    visit(child, child.name, None)
                else:
                    visit(child, cls, fn)
        visit(tree, None, None)

    def _collect_tensor_attrs(self) -> None:
        for info in self.functions.values():
            cls = info.parent_class
            if cls is None:
                continue
            for node in walk_body(info.node):
                if not (isinstance(node, ast.Assign)
                        and isinstance(node.value, ast.Call)):
                    continue
                name = dotted_name(node.value.func) or ""
                if not _is_torch_tensor_call(name):
                    continue
                for t in node.targets:
                    if (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        self.tensor_attrs.setdefault(cls, set()).add(t.attr)

    def _calls(self, info: FunctionInfo) -> Iterator[ast.Call]:
        for node in walk_body(info.node):
            if isinstance(node, ast.Call):
                yield node

    def _find_roots(self) -> Set[str]:
        roots: Set[str] = set()
        for info in self.functions.values():
            for call in self._calls(info):
                term = terminal_name(call.func)
                if ((term == "replay" and isinstance(call.func,
                                                     ast.Attribute)
                     and not call.args) or term in KNOWN_STEPS):
                    roots.add(info.qualname)
                    break
        return roots

    def _referenced_names(self, info: FunctionInfo) -> Iterator[str]:
        for node in walk_body(info.node):
            if isinstance(node, ast.Attribute) and isinstance(
                    node.value, ast.Name) and node.value.id == "self":
                yield node.attr
            elif isinstance(node, ast.Name) and isinstance(node.ctx,
                                                           ast.Load):
                yield node.id

    def _close_hot(self) -> Set[str]:
        # Callers of the roots, transitively (any name).
        hot = set(self.roots)
        changed = True
        while changed:
            changed = False
            for info in self.functions.values():
                if info.qualname in hot:
                    continue
                names = set(self._referenced_names(info))
                if any(q in hot for n in names
                       for q in self._by_bare.get(n, ())):
                    hot.add(info.qualname)
                    changed = True
        # Then down over the private helpers they reference, and the
        # defs nested in them.
        done: Set[str] = set()
        pending = list(hot)
        while pending:
            qual = pending.pop()
            if qual in done or qual not in self.functions:
                continue
            done.add(qual)
            for other in self.functions.values():
                if other.parent_fn == qual:
                    pending.append(other.qualname)
            for name in self._referenced_names(self.functions[qual]):
                if name.startswith("_") and not name.startswith("__"):
                    pending.extend(self._by_bare.get(name, ()))
        return done


class TensorTracker:
    """Syntactic tensor-value propagation inside ONE function body."""

    def __init__(self, info: FunctionInfo, index: ModuleIndex):
        self.info = info
        self.attrs = index.tensor_attrs.get(info.parent_class or "", set())
        self.tensors: Set[str] = self._evidenced_params()
        # Two passes: later assignments can feed earlier uses in loops.
        for _ in range(2):
            self._propagate()

    def _evidenced_params(self) -> Set[str]:
        out: Set[str] = set()
        params = set(self.info.params) - {"self"}
        for node in walk_body(self.info.node):
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id in params
                    and node.attr in TENSOR_EVIDENCE_ATTRS):
                out.add(node.value.id)
        return out

    def _mark(self, target: ast.AST, tensor: bool) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._mark(el, tensor)
            return
        if isinstance(target, ast.Name):
            if tensor:
                self.tensors.add(target.id)
            else:
                self.tensors.discard(target.id)

    def _propagate(self) -> None:
        for node in walk_body(self.info.node):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, (ast.Tuple, ast.List)) and isinstance(
                            node.value, (ast.Tuple, ast.List)):
                        for el, v in zip(t.elts, node.value.elts):
                            self._mark(el, self.is_tensor(v))
                    else:
                        self._mark(t, self.is_tensor(node.value))
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign,
                                   ast.NamedExpr)):
                if node.value is not None and self.is_tensor(node.value):
                    self._mark(node.target, True)

    def is_tensor(self, expr: ast.AST) -> bool:
        """Does this expression produce a tensor?"""
        if isinstance(expr, ast.Call):
            name = dotted_name(expr.func) or ""
            if name.split(".")[0] in {"np", "numpy"}:
                return False
            if name.split(".")[-1] == "host_sync":
                return False
            if _is_torch_tensor_call(name):
                return True
            if isinstance(expr.func, ast.Attribute):
                if expr.func.attr in HOST_METHODS | STATIC_ATTRS:
                    return False
                return self.is_tensor(expr.func.value)
            return False
        if isinstance(expr, ast.Name):
            return expr.id in self.tensors
        if isinstance(expr, ast.Attribute):
            if expr.attr in STATIC_ATTRS:
                return False
            if (isinstance(expr.value, ast.Name)
                    and expr.value.id == "self"):
                return expr.attr in self.attrs
            return self.is_tensor(expr.value)
        if isinstance(expr, ast.Subscript):
            return self.is_tensor(expr.value)
        if isinstance(expr, ast.BinOp):
            return self.is_tensor(expr.left) or self.is_tensor(expr.right)
        if isinstance(expr, ast.UnaryOp):
            return self.is_tensor(expr.operand)
        if isinstance(expr, ast.Compare):
            return self.is_tensor(expr.left) or any(
                self.is_tensor(c) for c in expr.comparators)
        if isinstance(expr, ast.IfExp):
            return self.is_tensor(expr.body) or self.is_tensor(expr.orelse)
        return False
