"""DES-invariant lint: a custom AST pass over the repo's source tree.

Three rules protect the invariants the cost model and the race analyzer
both rely on (tests are exempt — they legitimately unit-test the raw
primitives and hand-build ledgers):

* **ANA001 — metadata primitives stay behind the layers.**  Direct
  ``bfs_attach`` / ``bfs_attach_file`` / ``bfs_query`` /
  ``bfs_query_file`` calls are allowed only in
  ``core/consistency.py`` (the layers ARE the placement policy under
  study — Table 6) and ``core/basefs.py`` itself.  Anything else
  calling them would move attach/query placement out of the model
  comparison.
* **ANA002 — every registered layer declares its fence classes.**
  Each class in ``core/consistency.py`` deriving from ``_LayeredFS``
  must assign ``name``, ``sync_points``, ``consumer_edges`` and
  ``sync_op_kinds`` in its own body (an explicit ``{}`` is PosixFS
  asserting S = ∅), and every ``sync_op_kinds`` key must be a method
  defined by the class — the race analyzer records exactly these, so a
  missing declaration silently drops formal sync ops from lifted
  executions.
* **ANA003 — no unpriced RPC emission.**  ``*.record(EventKind.RPC,
  ...)`` is allowed only in ``core/basefs.py``: every RPC must flow
  through the batcher/server so the DES prices it (and so
  ``Event.deps`` edges are stamped).  A stray hand-recorded RPC event
  would be free traffic.
* **ANA004 — fault stamps come from the fault plane.**  ``retries=`` /
  ``failover=`` keywords on ``record(...)`` / ``Event(...)`` calls are
  allowed only in ``core/basefs.py`` and ``core/faults.py``: the
  ledger stamps them from the seeded :class:`FaultSchedule` when the
  RPC is recorded (``docs/FAULTS.md``).  Hand-stamped fault metadata
  anywhere else would be retries the schedule never drew — priced
  delay without an injected fault, breaking per-seed determinism and
  the ``faults=None`` bitwise-identity guarantee.
* **ANA005 — bulk submission enters through the layer API only.**
  The columnar execution kernels — ``bulk_write_run`` /
  ``bulk_read_run`` on ``BaseFS`` and the batcher's ``submit_run`` —
  append ledger rows directly and may only be called from
  ``core/consistency.py`` (``run_ops``, the layer bulk API) and
  ``core/basefs.py`` itself.  Any other caller would bypass the
  layer's sync-point placement and its ``sync_op_kinds`` hooks —
  exactly the per-model difference under study — so workloads and
  benchmarks must submit op programs via ``run_ops``, never drive a
  kernel themselves (``docs/ARCHITECTURE.md``, execution plane).

``run_lint()`` returns violations; the CLI (``python -m repro_torch.analysis
--lint``) and the blocking ``make analyze-smoke`` CI step exit nonzero
on any.

This copy lints the port.  Its one difference from ``repro.analysis.lint``
is the paths: :data:`SCAN_DIRS` is ``src/repro_torch`` (the port's examples
live inside the package), and the allow-lists name the port's own
``src/repro_torch/core/consistency.py``, ``basefs.py`` and ``faults.py``.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

#: Call names guarded by ANA001.
_GUARDED_CALLS = frozenset({
    "bfs_attach", "bfs_attach_file", "bfs_query", "bfs_query_file",
})
#: Files (relative, /-separated) where ANA001 calls are legitimate.
_ANA001_ALLOWED = ("src/repro_torch/core/consistency.py",
                   "src/repro_torch/core/basefs.py")
#: Files where ANA003 may record EventKind.RPC directly.
_ANA003_ALLOWED = ("src/repro_torch/core/basefs.py",)
#: Files where ANA004 may stamp fault metadata on events.
_ANA004_ALLOWED = ("src/repro_torch/core/basefs.py", "src/repro_torch/core/faults.py")
#: Bulk execution kernels guarded by ANA005 …
_BULK_KERNELS = frozenset({"bulk_write_run", "bulk_read_run", "submit_run"})
#: … and the files allowed to call them (the layer API + BaseFS).
_ANA005_ALLOWED = ("src/repro_torch/core/consistency.py",
                   "src/repro_torch/core/basefs.py")
#: Keywords ANA004 guards on record()/Event() calls.
_FAULT_KEYWORDS = frozenset({"retries", "failover"})
#: Class-body assignments ANA002 requires of every layer.
_LAYER_DECLS = ("name", "sync_points", "consumer_edges", "sync_op_kinds")

#: Directories scanned relative to the repo root.
SCAN_DIRS = ("src/repro_torch",)


@dataclass(frozen=True)
class Violation:
    rule: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


def _call_name(node: ast.Call) -> Optional[str]:
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def _is_eventkind_rpc(arg: ast.expr) -> bool:
    return (isinstance(arg, ast.Attribute) and arg.attr == "RPC"
            and isinstance(arg.value, ast.Name)
            and arg.value.id == "EventKind")


def _lint_calls(tree: ast.AST, rel: str, out: List[Violation]) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node)
        if name in _GUARDED_CALLS and rel not in _ANA001_ALLOWED:
            out.append(Violation(
                "ANA001", rel, node.lineno,
                f"direct {name}() outside the consistency layers — "
                "attach/query placement belongs to core/consistency.py"))
        if (name == "record" and node.args
                and _is_eventkind_rpc(node.args[0])
                and rel not in _ANA003_ALLOWED):
            out.append(Violation(
                "ANA003", rel, node.lineno,
                "hand-recorded EventKind.RPC event — RPCs must go "
                "through the batcher/server so the DES prices them"))
        if name in _BULK_KERNELS and rel not in _ANA005_ALLOWED:
            out.append(Violation(
                "ANA005", rel, node.lineno,
                f"direct {name}() call bypasses the layer bulk API — "
                "op programs must be submitted through run_ops() so "
                "sync_op_kinds hooks and sync-point placement stay "
                "with the consistency layer"))
        if (name in ("record", "Event") and rel not in _ANA004_ALLOWED):
            stamped = sorted(
                kw.arg for kw in node.keywords
                if kw.arg in _FAULT_KEYWORDS)
            if stamped:
                out.append(Violation(
                    "ANA004", rel, node.lineno,
                    f"hand-stamped fault metadata ({', '.join(stamped)}) "
                    "— retry/failover stamps come from the seeded "
                    "FaultSchedule inside core/basefs.py, never from "
                    "callers"))


def _lint_layer_decls(tree: ast.AST, rel: str,
                      out: List[Violation]) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        bases = {b.id for b in node.bases if isinstance(b, ast.Name)}
        if "_LayeredFS" not in bases:
            continue
        assigns = {}
        methods = set()
        for stmt in node.body:
            if isinstance(stmt, ast.Assign):
                for tgt in stmt.targets:
                    if isinstance(tgt, ast.Name):
                        assigns[tgt.id] = stmt.value
            elif isinstance(stmt, ast.AnnAssign) and isinstance(
                    stmt.target, ast.Name):
                assigns[stmt.target.id] = stmt.value
            elif isinstance(stmt, ast.FunctionDef):
                methods.add(stmt.name)
        for decl in _LAYER_DECLS:
            if decl not in assigns:
                out.append(Violation(
                    "ANA002", rel, node.lineno,
                    f"layer {node.name} does not declare {decl!r} "
                    "in its class body"))
        kinds = assigns.get("sync_op_kinds")
        if isinstance(kinds, ast.Dict):
            for key in kinds.keys:
                if (isinstance(key, ast.Constant)
                        and isinstance(key.value, str)
                        and key.value not in methods):
                    out.append(Violation(
                        "ANA002", rel, key.lineno,
                        f"layer {node.name} declares sync op "
                        f"{key.value!r} but defines no such method"))


def lint_source(source: str, rel: str) -> List[Violation]:
    """Lint one file's source; ``rel`` is its /-separated repo path."""
    out: List[Violation] = []
    tree = ast.parse(source, filename=rel)
    _lint_calls(tree, rel, out)
    if rel.endswith("core/consistency.py"):
        _lint_layer_decls(tree, rel, out)
    return out


def run_lint(root: Optional[str] = None,
             dirs: Sequence[str] = SCAN_DIRS) -> List[Violation]:
    """Lint every ``*.py`` under ``dirs`` (relative to the repo root)."""
    if root is None:
        # src/repro_torch/analysis/lint.py -> repo root is three dirs up.
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
    out: List[Violation] = []
    for d in dirs:
        base = os.path.join(root, d)
        for dirpath, _dirnames, filenames in os.walk(base):
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fn)
                rel = os.path.relpath(path, root).replace(os.sep, "/")
                with open(path, encoding="utf-8") as f:
                    out.extend(lint_source(f.read(), rel))
    return out
