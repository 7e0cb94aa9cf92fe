"""Pass 2 — process-group contracts over ``src/repro_torch/`` (the
port's counterpart of the reference's ``src/repro/analysis/collectives.py``).

Four AST lints:

* ``axis-literal`` — axis-name string literals ("data", "model", ...)
  anywhere outside ``repro_torch/core/axes.py`` (docstrings exempt): every
  axis name comes from the one constants module, so a typo is a
  NameError, not a group that does not exist.

* ``unbound-axis`` — a mesh group or collective named by an axis that is
  not in ``repro_torch.core.axes.MESH_AXES``: the axis argument of
  ``<mesh>.group`` / ``.size`` / ``.index`` / ``.group_for`` (a receiver
  whose name ends in ``mesh``; ``group_for`` takes a tuple, each of its
  names checked: the `tp` axis and the model-parallel (`model`, `tp`)
  group are named so) and of ``gather_axis``,
  where the resolver can evaluate it statically (constants, tuples,
  ``axes.X``, imported names, local and module assignments, parameters
  through their in-module call sites, to a small depth; dynamic
  expressions are skipped, as in the reference).

* ``raw-collective`` — a ``torch.distributed`` collective called outside
  ``launch/mesh.py``.  Every collective goes through one ``Mesh`` method
  a kind, which also records it (``Mesh.records``, the dry run's
  ``RecordingMesh``); a raw call bypasses both the mesh's group and the
  recorder.

* ``dropped-ordering`` — an all-to-all whose completion is not ordered
  before the compute stream's next work: a function that issues
  ``<mesh>.all_to_all`` with ``async_op`` must return its work handle,
  and a caller of a work-returning exchange (``TOKEN_PRODUCERS``) with
  ``async_op`` must keep the handle or call ``<mesh>.mark("a2a")`` after
  it (the event ``Mesh.a2a_event`` the gradient reduction waits on).  A
  call without ``async_op`` (or with the constant False) blocks and
  returns no handle, so it has no ordering to drop.  The port's
  counterpart of the reference's dropped a2a token: issue order plus
  CUDA event waits.
"""
from __future__ import annotations

import ast
import os

from repro_torch.analysis.findings import Finding
from repro_torch.core import axes as _axes_mod

AXES_MODULE = "repro_torch.core.axes"

# mesh accessor / helper -> positional index of its axis argument
AXIS_CALLS = {"group": 0, "size": 0, "index": 0, "group_for": 0,
              "gather_axis": 2}
_AXIS_KWARG = "axis"

# torch.distributed's collectives (and the barrier)
RAW_COLLECTIVES = {
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_single", "all_gather_object", "all_to_all",
    "all_to_all_single", "reduce_scatter", "reduce_scatter_tensor",
    "reduce_scatter_single", "broadcast", "broadcast_object_list", "reduce",
    "gather", "scatter", "send", "recv", "isend", "irecv", "barrier",
    "monitored_barrier", "batch_isend_irecv"}

# work-returning exchange -> (index of the work handle in its result,
# position of its async_op argument)
TOKEN_PRODUCERS = {"_exchange": (1, 2)}

_MAX_DEPTH = 3
MESH_MODULE = "launch/mesh.py"


def canonical_axes() -> set:
    """All scalar axis names exported by repro_torch.core.axes."""
    vals = set()
    for name in dir(_axes_mod):
        if not name.isupper():
            continue
        v = getattr(_axes_mod, name)
        if isinstance(v, str):
            vals.add(v)
        elif isinstance(v, tuple):
            vals.update(x for x in v if isinstance(x, str))
    return vals


def _axes_constants() -> dict:
    return {name: getattr(_axes_mod, name) for name in dir(_axes_mod)
            if name.isupper()}


# ------------------------------------------------------------ module map --

class _ModuleInfo:
    """Per-file symbol tables the resolver consults."""

    def __init__(self, tree: ast.Module):
        self.tree = tree
        self.module_assigns: dict[str, ast.expr] = {}
        self.axes_aliases: set[str] = set()       # `axes`, `ax`, ...
        self.imported_axes: dict[str, object] = {}  # EP_AXIS -> "model"
        self.functions: dict[str, ast.FunctionDef] = {}
        consts = _axes_constants()
        for node in tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                self.module_assigns[node.targets[0].id] = node.value
            elif isinstance(node, ast.ImportFrom):
                if node.module == AXES_MODULE:
                    for a in node.names:
                        if a.name in consts:
                            self.imported_axes[a.asname or a.name] = \
                                consts[a.name]
                elif node.module == "repro_torch.core":
                    for a in node.names:
                        if a.name == "axes":
                            self.axes_aliases.add(a.asname or "axes")
            elif isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == AXES_MODULE:
                        self.axes_aliases.add(a.asname or "repro_torch")
        for node in ast.walk(tree):
            if isinstance(node, ast.FunctionDef):
                self.functions[node.name] = node


def _docstring_nodes(tree: ast.Module) -> set:
    ids = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef,
                             ast.AsyncFunctionDef, ast.ClassDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) \
                    and isinstance(body[0].value, ast.Constant) \
                    and isinstance(body[0].value.value, str):
                ids.add(id(body[0].value))
    return ids


# -------------------------------------------------------------- resolver --

class _Unknown(Exception):
    pass


def _local_assigns(fn: ast.FunctionDef) -> dict:
    out = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            out[node.targets[0].id] = node.value
    return out


def _param_default(fn: ast.FunctionDef, name: str):
    args = fn.args
    pos = args.posonlyargs + args.args
    n_def = len(args.defaults)
    for i, a in enumerate(pos):
        if a.arg == name and i >= len(pos) - n_def:
            return args.defaults[i - (len(pos) - n_def)]
    for a, d in zip(args.kwonlyargs, args.kw_defaults):
        if a.arg == name and d is not None:
            return d
    return None


def _param_index(fn: ast.FunctionDef, name: str) -> int | None:
    pos = fn.args.posonlyargs + fn.args.args
    for i, a in enumerate(pos):
        if a.arg == name:
            return i
    return None


def _is_param(fn: ast.FunctionDef, name: str) -> bool:
    args = fn.args
    return any(a.arg == name for a in
               args.posonlyargs + args.args + args.kwonlyargs)


def _callsite_exprs(info: _ModuleInfo, fn_name: str, param: str,
                    param_idx: int | None):
    """(caller_fn_or_None, expr) pairs binding ``param`` at each in-module
    call of ``fn_name`` — direct calls and functools.partial."""
    out = []
    for caller in [None] + list(info.functions.values()):
        body = info.tree if caller is None else caller
        for node in ast.walk(body):
            if not isinstance(node, ast.Call):
                continue
            callee, args, kwargs = None, node.args, node.keywords
            f = node.func
            if isinstance(f, ast.Name) and f.id == fn_name:
                callee = fn_name
            elif isinstance(f, ast.Attribute) and f.attr == fn_name:
                callee = fn_name
            elif (isinstance(f, ast.Name) and f.id == "partial"
                  or isinstance(f, ast.Attribute) and f.attr == "partial"):
                if args and ((isinstance(args[0], ast.Name)
                              and args[0].id == fn_name)
                             or (isinstance(args[0], ast.Attribute)
                                 and args[0].attr == fn_name)):
                    callee, args = fn_name, args[1:]
                    param_idx_here = None  # partial: keywords only
                else:
                    continue
            if callee is None:
                continue
            bound = None
            for kw in kwargs:
                if kw.arg == param:
                    bound = kw.value
            if bound is None and param_idx is not None \
                    and not (isinstance(f, (ast.Name, ast.Attribute))
                             and getattr(f, "id", getattr(f, "attr", ""))
                             == "partial") \
                    and param_idx < len(args):
                bound = args[param_idx]
            if bound is not None:
                out.append((caller, bound))
    return out


def _resolve(expr, info: _ModuleInfo, fn: ast.FunctionDef | None,
             depth: int = 0) -> list:
    """Evaluate an axis expression to its list of axis-name strings.
    Raises _Unknown for anything dynamic."""
    if depth > _MAX_DEPTH:
        raise _Unknown
    if isinstance(expr, ast.Constant):
        if isinstance(expr.value, str):
            return [expr.value]
        raise _Unknown
    if isinstance(expr, (ast.Tuple, ast.List)):
        vals = []
        for e in expr.elts:
            vals.extend(_resolve(e, info, fn, depth + 1))
        return vals
    if isinstance(expr, ast.Attribute) \
            and isinstance(expr.value, ast.Name) \
            and expr.value.id in info.axes_aliases:
        v = _axes_constants().get(expr.attr)
        if isinstance(v, str):
            return [v]
        if isinstance(v, tuple):
            return list(v)
        raise _Unknown
    if isinstance(expr, ast.Name):
        name = expr.id
        if fn is not None:
            local = _local_assigns(fn)
            if name in local:
                return _resolve(local[name], info, fn, depth + 1)
            default = _param_default(fn, name)
            if default is not None:
                return _resolve(default, info, fn, depth + 1)
            if _is_param(fn, name):
                sites = _callsite_exprs(info, fn.name, name,
                                        _param_index(fn, name))
                if not sites:
                    raise _Unknown
                vals = []
                for caller, bound in sites:
                    vals.extend(_resolve(bound, info, caller, depth + 1))
                return vals
        if name in info.imported_axes:
            v = info.imported_axes[name]
            return list(v) if isinstance(v, tuple) else [v]
        if name in info.module_assigns:
            return _resolve(info.module_assigns[name], info, None, depth + 1)
    raise _Unknown


# --------------------------------------------------------------- checks ---

def _call_name(node: ast.Call):
    f = node.func
    return f.attr if isinstance(f, ast.Attribute) else \
        (f.id if isinstance(f, ast.Name) else None)


def _owner(info: _ModuleInfo, node) -> ast.FunctionDef | None:
    """The innermost function holding ``node`` (None: module level)."""
    best = None
    for g in info.functions.values():
        if any(n is node for n in ast.walk(g)):
            if best is None or any(n is g for n in ast.walk(best)):
                best = g
    return best


def _check_axes(rel: str, info: _ModuleInfo, canon: set) -> list:
    findings = []
    for node in ast.walk(info.tree):
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node)
        if name not in AXIS_CALLS:
            continue
        if name != "gather_axis" and not (
                isinstance(node.func, ast.Attribute) and
                ast.unparse(node.func.value).endswith("mesh")):
            continue
        expr = None
        for kw in node.keywords:
            if kw.arg == _AXIS_KWARG:
                expr = kw.value
        idx = AXIS_CALLS[name]
        if expr is None and idx < len(node.args):
            expr = node.args[idx]
        if expr is None:
            continue
        fn = _owner(info, node)
        try:
            vals = _resolve(expr, info, fn)
        except _Unknown:
            continue
        bad = sorted(set(v for v in vals if v not in canon))
        if bad:
            findings.append(Finding(
                "unbound-axis", rel, fn.name if fn else "<module>",
                f"{name}:{','.join(bad)}",
                f"{name} at {rel}:{node.lineno} names axis {bad}, not one "
                f"of the mesh's (repro_torch.core.axes.MESH_AXES = "
                f"{sorted(canon)})", lineno=node.lineno))
    return findings


def _check_axis_literals(rel: str, tree: ast.Module, canon: set) -> list:
    doc_ids = _docstring_nodes(tree)
    uniq: dict = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and node.value in canon and id(node) not in doc_ids:
            uniq.setdefault(node.value, Finding(
                "axis-literal", rel, "<module>", f"{node.value}@L0",
                f'axis name "{node.value}" appears as a string literal at '
                f"{rel}:{node.lineno}: import it from repro_torch.core.axes "
                f"so that a typo fails at import time", lineno=node.lineno))
    return list(uniq.values())


def _dist_aliases(tree: ast.Module) -> tuple:
    """(names bound to the torch.distributed module, names bound to one of
    its collectives)."""
    mods, funcs = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch.distributed" and a.asname:
                    mods.add(a.asname)
        elif isinstance(node, ast.ImportFrom):
            if node.module == "torch":
                for a in node.names:
                    if a.name == "distributed":
                        mods.add(a.asname or "distributed")
            elif node.module == "torch.distributed":
                for a in node.names:
                    if a.name in RAW_COLLECTIVES:
                        funcs.add(a.asname or a.name)
    return mods, funcs


def _is_torch_distributed(expr) -> bool:
    return isinstance(expr, ast.Attribute) and expr.attr == "distributed" \
        and isinstance(expr.value, ast.Name) and expr.value.id == "torch"


def _check_raw(rel: str, info: _ModuleInfo) -> list:
    if rel.endswith(MESH_MODULE):
        return []
    mods, funcs = _dist_aliases(info.tree)
    findings = []
    for node in ast.walk(info.tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        hit = None
        if isinstance(f, ast.Attribute) and f.attr in RAW_COLLECTIVES and (
                (isinstance(f.value, ast.Name) and f.value.id in mods)
                or _is_torch_distributed(f.value)):
            hit = f.attr
        elif isinstance(f, ast.Name) and f.id in funcs:
            hit = f.id
        if hit:
            fn = _owner(info, node)
            findings.append(Finding(
                "raw-collective", rel, fn.name if fn else "<module>", hit,
                f"torch.distributed.{hit} at {rel}:{node.lineno}: issue "
                f"collectives through the mesh's methods (launch/mesh.py), "
                f"which the dry run's recorder sees", lineno=node.lineno))
    return findings


def _marks_after(fn: ast.FunctionDef, lineno: int) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and _call_name(node) == "mark" \
                and node.lineno >= lineno and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and node.args[0].value == "a2a":
            return True
    return False


def _name_read_after(fn_body, name: str, after_lineno: int) -> bool:
    for node in ast.walk(fn_body):
        if isinstance(node, ast.Name) and node.id == name \
                and isinstance(node.ctx, ast.Load) \
                and getattr(node, "lineno", 0) >= after_lineno:
            return True
    return False


def _returns_name(fn: ast.FunctionDef, name: str) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Return) and node.value is not None and \
                any(isinstance(n, ast.Name) and n.id == name
                    for n in ast.walk(node.value)):
            return True
    return False


def _is_async(call: ast.Call, producers: dict) -> bool:
    """Whether ``call`` may return a work handle: its ``async_op``,
    passed by keyword or at the producer's position, is not absent or the
    constant False."""
    arg = next((k.value for k in call.keywords if k.arg == "async_op"),
               None)
    pos = producers.get(_call_name(call), (None, None))[1]
    if arg is None and pos is not None and len(call.args) > pos:
        arg = call.args[pos]
    return arg is not None and not (isinstance(arg, ast.Constant) and
                                    arg.value is False)


def _check_ordering(rel: str, info: _ModuleInfo,
                    producers: dict | None = None) -> list:
    producers = TOKEN_PRODUCERS if producers is None else producers
    findings = []
    if rel.endswith(MESH_MODULE):
        return findings
    for fn in info.functions.values():
        for stmt in ast.walk(fn):
            # a direct all-to-all: its work handle must leave the function
            # (the caller orders it) or a mark must follow
            if isinstance(stmt, ast.Assign) and \
                    isinstance(stmt.value, ast.Call) and \
                    _call_name(stmt.value) == "all_to_all" and \
                    isinstance(stmt.value.func, ast.Attribute) and \
                    _is_async(stmt.value, producers):
                tgt = stmt.targets[0]
                if not (isinstance(tgt, ast.Name) and
                        _returns_name(fn, tgt.id)) and \
                        not _marks_after(fn, stmt.lineno):
                    findings.append(Finding(
                        "dropped-ordering", rel, fn.name, "all_to_all",
                        f"all_to_all at {rel}:{stmt.lineno}: its work is "
                        f"neither returned nor followed by mark(\"a2a\")",
                        lineno=stmt.lineno))
            elif isinstance(stmt, ast.Expr) and \
                    isinstance(stmt.value, ast.Call) and \
                    _call_name(stmt.value) in ("all_to_all", *producers) \
                    and _is_async(stmt.value, producers) \
                    and not _marks_after(fn, stmt.lineno):
                findings.append(Finding(
                    "dropped-ordering", rel, fn.name,
                    f"{_call_name(stmt.value)}:discarded",
                    f"{_call_name(stmt.value)} at {rel}:{stmt.lineno} "
                    f"discards its work handle and no mark(\"a2a\") "
                    f"follows", lineno=stmt.lineno))
            elif isinstance(stmt, (ast.Assign, ast.Return)) and \
                    stmt.value is not None:
                for call in ast.walk(stmt.value):
                    if not (isinstance(call, ast.Call) and
                            _call_name(call) in producers and
                            _is_async(call, producers)):
                        continue
                    name = _call_name(call)
                    tok = None
                    if isinstance(stmt, ast.Assign) and \
                            call is stmt.value and \
                            isinstance(stmt.targets[0], ast.Tuple):
                        elts = stmt.targets[0].elts
                        at = producers[name][0]
                        if at < len(elts) and isinstance(elts[at],
                                                         ast.Name):
                            tok = elts[at].id
                    kept = isinstance(stmt, ast.Return) and \
                        call is stmt.value
                    if tok is not None and tok != "_" and \
                            _name_read_after(fn, tok, stmt.lineno + 1):
                        kept = True
                    if not kept and not _marks_after(fn, stmt.lineno):
                        findings.append(Finding(
                            "dropped-ordering", rel, fn.name,
                            f"{name}:{tok or 'discarded'}",
                            f"{name} at {rel}:{stmt.lineno}: its work "
                            f"handle is dropped and no mark(\"a2a\") "
                            f"follows: the gradient reduction can start "
                            f"before this all-to-all ends",
                            lineno=stmt.lineno))
    return findings


# ------------------------------------------------------------ entry point

def analyze_collectives(src_root: str, *,
                        rel_prefix: str = "src/repro_torch",
                        canon: set | None = None,
                        producers: dict | None = None) -> list:
    """Run pass 2 over every .py under ``src_root`` (skipping axes.py and
    this analysis package itself)."""
    canon = canonical_axes() if canon is None else canon
    findings = []
    for dirpath, dirnames, filenames in os.walk(src_root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", "build"))
        if os.path.basename(dirpath) == "analysis":
            continue
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            rel = os.path.relpath(path, src_root).replace(os.sep, "/")
            rel = f"{rel_prefix}/{rel}" if rel_prefix else rel
            if rel.endswith("core/axes.py"):
                continue
            with open(path) as fh:
                tree = ast.parse(fh.read(), filename=path)
            info = _ModuleInfo(tree)
            findings.extend(_check_axis_literals(rel, tree, canon))
            findings.extend(_check_axes(rel, info, canon))
            findings.extend(_check_raw(rel, info))
            findings.extend(_check_ordering(rel, info, producers))
    return findings
