"""Sort ownership in the port, modelled on ``tools/check_no_raw_sort.py``
and ``tests/test_no_raw_sort.py``: the one-sort-per-graph invariant (paper
§3.4, ``core/layout.py``) holds only if no model, kernel wrapper or
serving module of ``src/repro_torch/`` re-derives the edge order.  An AST
walk of every module outside ``core/`` fails on a call to

  * ``sort_by_segment`` (the CSC sort primitive), bare or qualified;
  * ``argsort`` / ``lexsort`` in any spelling (a bare import, a module's
    attribute, a tensor's method);
  * ``sort`` as an attribute of an array-library module (``torch.sort``,
    ``np.sort``, ``numpy.sort``) — Python's list ``.sort()`` and
    ``sorted()`` on host data stay allowed.

``core/`` itself is exempt: its ``layout.build_layout``, ``host_layout``,
``scatter_gather.sort_by_segment`` and ``graph.coo_to_compressed`` are
the sorts.  Each rule has a failing fixture, so the guard cannot pass by
checking nothing.
"""
import ast
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
EXEMPT_PREFIX = ("core",)  # package parts under src/repro_torch that may sort
BANNED_ANYWHERE = {"sort_by_segment", "argsort", "lexsort"}  # bare or attribute
ARRAY_MODULES = {"torch", "np", "numpy"}


def _attr_root(node: ast.AST):
    """Leftmost Name of a dotted attribute chain (``torch.Tensor.sort`` -> torch)."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _banned_call(func: ast.AST):
    if isinstance(func, ast.Name):
        return func.id if func.id in BANNED_ANYWHERE else None
    if isinstance(func, ast.Attribute):
        if func.attr in BANNED_ANYWHERE:
            return func.attr
        if func.attr == "sort" and _attr_root(func) in ARRAY_MODULES:
            return "sort"
    return None


def violations(source: str, rel: str) -> list:
    """``rel:line: raw edge sort `name``` for every banned call."""
    out = []
    for node in ast.walk(ast.parse(source, filename=rel)):
        if isinstance(node, ast.Call):
            name = _banned_call(node.func)
            if name is not None:
                out.append(f"{rel}:{node.lineno}: raw edge sort `{name}` outside "
                           "core/ — thread a core.layout.GraphLayout instead")
    return out


def checked_modules() -> list:
    return [p for p in sorted(PORT.rglob("*.py"))
            if p.relative_to(PORT).parts[:len(EXEMPT_PREFIX)] != EXEMPT_PREFIX]


def test_no_module_outside_core_sorts_edges():
    mods = checked_modules()
    assert len(mods) > 40  # the walk reaches the package
    errors = [e for p in mods
              for e in violations(p.read_text(), str(p.relative_to(PORT)))]
    assert errors == []


def test_core_holds_the_sorts_the_guard_exempts():
    """The exemption is not idle: ``core/`` does sort (else the guard's
    carve-out would hide nothing and could go)."""
    errors = [e for p in sorted((PORT / "core").rglob("*.py"))
              for e in violations(p.read_text(), str(p.relative_to(PORT)))]
    assert any("sort" in e for e in errors)


def test_guard_flags_raw_sorts():
    bad = (
        "import torch, numpy as np\n"
        "from torch import argsort\n"
        "from repro_torch.core.scatter_gather import sort_by_segment\n"
        "def f(ids, n):\n"
        "    perm, s, o = sort_by_segment(ids, n)\n"
        "    a = argsort(ids)            # bare-name import\n"
        "    b = torch.argsort(ids)\n"
        "    c = np.lexsort((ids,))\n"
        "    d = torch.sort(ids, stable=True)\n"
        "    e = ids.argsort()           # a tensor's method\n"
        "    return np.sort(ids)\n"
    )
    errors = violations(bad, "rogue.py")
    for needle in ("sort_by_segment", "argsort", "lexsort", "`sort`"):
        assert any(needle in e for e in errors), (needle, errors)
    assert len(errors) == 7


def test_guard_allows_plan_consumers_and_host_sorts():
    ok = (
        "from repro_torch.core import layout as LY\n"
        "def f(layout, graph, msgs, recs):\n"
        "    recs.sort(key=len)          # host-side list sort is fine\n"
        "    xs = sorted(recs)\n"
        "    return LY.segment_reduce(layout, msgs), xs\n"
    )
    assert violations(ok, "fine.py") == []
