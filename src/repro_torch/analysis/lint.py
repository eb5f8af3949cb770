"""AST lint of ``src/repro_torch`` (rules LINT001–LINT006), the
reference's ``analysis/lint.py`` with its rules read for PyTorch:

  * LINT001 — no ``.item()``, ``float(...)``, ``.cpu()``, ``.tolist()``
    or ``torch.cuda.synchronize`` in the engine's hot-loop modules
    (``engine/{executors,exec_core,sharded,flat,pipelined}.py``): a host
    sync stalls the queue of launches the executors keep ahead of the
    card. Cold code is exempt.
  * LINT002 — no ``F.pad`` / ``np.pad`` / ``torch.nn.functional.pad`` in
    ``kernels/``: padding materializes a copy; the kernels mask their
    ragged tail instead.
  * LINT003 — an in-place write (``copy_``, ``index_copy_``, ...) to a
    serving pool or cache in ``engine/`` sits in a function that reads
    the ``donate`` flag, so a caller can opt out (``donate=False``) — the
    counterpart of a ``donate_argnums`` derived from a flag.
  * LINT004 — every kernel launch (the wrapper's ``LAUNCHES[...] += 1``
    that counts it) sits in a module of ``kernels/`` that calls its plain
    twin in ``kernels/ref.py``, and no ``try``/``except`` wraps it: a
    failed launch raises, it never falls back to the plain version
    silently (the counterpart of "every ``pallas_call`` plumbs
    ``interpret=``").
  * LINT005 — production code imports kernels through the
    ``repro_torch.kernels`` public surface, not deep submodule paths.
  * LINT006 — a bare ``except Exception``/``BaseException`` in
    ``src/repro_torch/engine/`` routes the exception through the
    supervisor's fault taxonomy (``faults`` / ``is_oom`` /
    ``is_transient`` / ``classify`` / an error class of
    ``engine.faults``) or carries ``# repro: noqa(LINT006)``.

Intentional violations are waived inline with ``# repro: noqa(RULE)``
and a reason (or a bare ``# repro: noqa`` to waive every rule on that
statement); LINT006's waiver sits on the ``except`` line.
"""
from __future__ import annotations

import ast
import os
import re
from typing import List, Optional, Sequence

from .findings import Finding, SEVERITY_ERROR

#: engine modules whose bodies run once per micro-batch or per step
HOT_LOOP_MODULES = frozenset({"executors.py", "exec_core.py", "sharded.py",
                              "flat.py", "pipelined.py"})

_NOQA_RE = re.compile(r"#\s*repro:\s*noqa(?:\(([A-Za-z0-9_,\s]*)\))?")

_DEEP_KERNEL_RE = re.compile(r"(^|\.)kernels\.\w+")

#: in-place writes LINT003 looks at, and the names that make a receiver
#: a serving pool or cache
_INPLACE_WRITES = frozenset({"copy_", "index_copy_", "index_put_",
                             "scatter_", "fill_", "zero_", "masked_fill_"})
_POOL_NAMES = ("pool", "cache")

#: identifiers that count as "routing through the fault taxonomy" when
#: they appear in a bare except-Exception handler body (LINT006)
FAULT_TAXONOMY_NAMES = frozenset({
    "faults", "classify", "is_oom", "is_transient",
    "FaultError", "TransientError", "TransientWorkerError",
    "InjectedIOError", "InjectedCrash",
})


def category_for(path: str) -> str:
    parts = os.path.normpath(path).split(os.sep)
    base = os.path.basename(path)
    if "kernels" in parts:
        return "kernels"
    if "engine" in parts:
        return "engine-hot" if base in HOT_LOOP_MODULES else "engine"
    return "general"


def _noqa_rules(lines: Sequence[str], node: ast.AST) -> Optional[set]:
    """Waived rules for ``node``: None if no marker, empty set == waive
    all. Checks every source line the node spans (multi-line calls)."""
    start = getattr(node, "lineno", None)
    if start is None:
        return None
    end = getattr(node, "end_lineno", start) or start
    for ln in range(start, min(end, len(lines)) + 1):
        m = _NOQA_RE.search(lines[ln - 1])
        if m:
            rules = m.group(1)
            if not rules:
                return set()
            return {r.strip().upper() for r in rules.split(",") if r.strip()}
    return None


def _names(node: ast.AST):
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            yield sub.id
        elif isinstance(sub, ast.Attribute):
            yield sub.attr
        elif isinstance(sub, ast.keyword) and sub.arg:
            yield sub.arg


def _mentions(node: ast.AST, word: str) -> bool:
    return any(word in n.lower() for n in _names(node))


def _is_bare_exception_handler(handler: ast.ExceptHandler) -> bool:
    """True for ``except Exception``/``except BaseException`` (possibly
    inside a tuple). ``except:`` with no type is also bare."""
    typ = handler.type
    if typ is None:
        return True
    nodes = typ.elts if isinstance(typ, ast.Tuple) else [typ]
    for n in nodes:
        name = n.id if isinstance(n, ast.Name) else (
            n.attr if isinstance(n, ast.Attribute) else None)
        if name in ("Exception", "BaseException"):
            return True
    return False


def _routes_through_taxonomy(handler: ast.ExceptHandler) -> bool:
    return any(n in FAULT_TAXONOMY_NAMES for n in _names(handler))


def _is_launch_count(node: ast.AST) -> bool:
    """``LAUNCHES[...] += 1``: the statement a wrapper counts its launch
    with, right after it."""
    return (isinstance(node, ast.AugAssign)
            and isinstance(node.target, ast.Subscript)
            and isinstance(node.target.value, ast.Name)
            and node.target.value.id == "LAUNCHES")


def _calls_plain_twin(tree: ast.AST) -> bool:
    """The module calls a function of ``ref`` (kernels/ref.py)."""
    return any(isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
               and isinstance(n.func.value, ast.Name)
               and n.func.value.id == "ref" for n in ast.walk(tree))


def _parents(tree: ast.AST) -> dict:
    out = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            out[child] = node
    return out


def _enclosing(node, parents, kinds):
    while node in parents:
        node = parents[node]
        if isinstance(node, kinds):
            return node
    return None


def _in_try_with_handlers(node, parents) -> bool:
    child = node
    while child in parents:
        parent = parents[child]
        if (isinstance(parent, ast.Try) and parent.handlers
                and child in parent.body):
            return True
        child = parent
    return False


def lint_source(src: str, path: str = "<memory>", *,
                category: Optional[str] = None) -> List[Finding]:
    """Run every applicable AST rule over one source blob."""
    if category is None:
        category = category_for(path)
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:  # surfaced as a finding, not a crash
        return [Finding("LINT005", SEVERITY_ERROR,
                        f"unparseable source: {e.msg}",
                        location=f"{path}:{e.lineno or 0}")]
    lines = src.splitlines()
    parents = _parents(tree)
    findings: List[Finding] = []
    functions = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)

    def emit(rule: str, node: ast.AST, message: str, **details):
        waived = _noqa_rules(lines, node)
        if waived is not None and (not waived or rule in waived):
            return
        findings.append(Finding(
            rule, SEVERITY_ERROR, message,
            location=f"{path}:{getattr(node, 'lineno', 0)}",
            details=details or {}))

    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            attr = f.attr if isinstance(f, ast.Attribute) else None
            if category == "engine-hot":
                if isinstance(f, ast.Name) and f.id == "float":
                    emit("LINT001", node,
                         "float(...) in an engine hot-loop module forces "
                         "a host sync when applied to a device value")
                elif attr in ("item", "tolist", "cpu"):
                    emit("LINT001", node,
                         f".{attr}() in an engine hot-loop module is a "
                         "blocking device->host transfer")
                elif attr == "synchronize":
                    emit("LINT001", node,
                         "synchronize() in an engine hot-loop module "
                         "stalls the host until the card drains")
            if (category == "kernels" and attr == "pad"
                    and isinstance(f.value, (ast.Name, ast.Attribute))):
                owner = (f.value.id if isinstance(f.value, ast.Name)
                         else f.value.attr)
                if owner in ("F", "np", "numpy", "functional", "nn"):
                    emit("LINT002", node,
                         f"{owner}.pad in kernels/ materializes a padded "
                         "copy — mask the ragged tail in-kernel instead")
            if (category in ("engine", "engine-hot")
                    and attr in _INPLACE_WRITES
                    and any(w in n.lower() for n in _names(f.value)
                            for w in _POOL_NAMES)):
                fn = _enclosing(node, parents, functions)
                if fn is None or not _mentions(fn, "donate"):
                    emit("LINT003", node,
                         f".{attr}() writes a serving pool or cache in "
                         "place without reading the donate flag — let "
                         "callers opt out (donate=False)")
        elif category == "kernels" and _is_launch_count(node):
            if not _calls_plain_twin(tree):
                emit("LINT004", node,
                     "kernel launch in a module with no plain twin in "
                     "kernels/ref.py — every kernel is held against one")
            elif _in_try_with_handlers(node, parents):
                emit("LINT004", node,
                     "try/except around a kernel launch — a failed "
                     "launch must raise, not fall back to the plain "
                     "version")
        elif (isinstance(node, ast.ExceptHandler)
              and category in ("engine", "engine-hot")
              and _is_bare_exception_handler(node)
              and not _routes_through_taxonomy(node)):
            # the noqa waiver must sit on the ``except`` line itself, not
            # anywhere in the (arbitrarily long) handler body
            marker = ast.Pass()
            marker.lineno = node.lineno
            marker.end_lineno = node.lineno
            emit("LINT006", marker,
                 "bare except Exception in src/repro_torch/engine/ — route "
                 "the exception through the fault taxonomy "
                 "(faults.is_oom/is_transient/classify) or waive with "
                 "# repro: noqa(LINT006)")
        elif isinstance(node, ast.ImportFrom) and category != "kernels":
            mod = node.module or ""
            if _DEEP_KERNEL_RE.search(mod) or (
                    node.level > 0 and mod.startswith("kernels.")):
                emit("LINT005", node,
                     f"deep kernel import {mod!r} — import from the "
                     "repro_torch.kernels public surface instead",
                     module=mod)
        elif isinstance(node, ast.Import) and category != "kernels":
            for alias in node.names:
                if _DEEP_KERNEL_RE.search(alias.name):
                    emit("LINT005", node,
                         f"deep kernel import {alias.name!r} — import "
                         "from the repro_torch.kernels public surface "
                         "instead", module=alias.name)
    return findings


def lint_paths(paths: Sequence[str]) -> List[Finding]:
    out: List[Finding] = []
    for p in paths:
        with open(p, "r", encoding="utf-8") as fh:
            out.extend(lint_source(fh.read(), p))
    return out


def repo_root() -> str:
    """The ``src/repro_torch`` package directory this module lives in."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def lint_repo(root: Optional[str] = None) -> List[Finding]:
    """Lint every production module under ``src/repro_torch/``."""
    root = root or repo_root()
    targets = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                targets.append(os.path.join(dirpath, fn))
    return lint_paths(targets)
