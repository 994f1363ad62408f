"""The (phi, A, gamma) contract in the port's model layers, modelled on
``tools/check_mp_spec.py`` and ``tests/test_mp_spec_guard.py``: a layer
the fused kernel (``kernels/fused_mp.py``) can run is declarative — an
``MPSpec`` plus operands, or ``core.message_passing.mp_layer``'s closure
form with its named aggregate helpers (``pna_aggregate``,
``dgn_aggregate``, ``gat_attention``).  An AST walk of every module under
``src/repro_torch/gnn/`` fails on a call, bare or attribute-qualified, to
the aggregation primitives:

  * ``gather_scatter`` / ``segment_reduce`` / ``sorted_segment_reduce``;
  * ``edge_softmax`` (reached through ``gat_attention``, never directly);
  * ``segment_sum`` / ``sort_by_segment``.

``core/``, ``kernels/``, tests and benchmarks are exempt: they implement
or deliberately compare the primitives.  Each rule has a failing
fixture, so the guard cannot pass by checking nothing.
"""
import ast
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
GNN = ROOT / "src" / "repro_torch" / "gnn"
BANNED = {"gather_scatter", "segment_reduce", "sorted_segment_reduce",
          "edge_softmax", "segment_sum", "sort_by_segment"}


def _banned_call(func: ast.AST):
    if isinstance(func, ast.Name) and func.id in BANNED:
        return func.id
    if isinstance(func, ast.Attribute) and func.attr in BANNED:
        return func.attr
    return None


def violations(source: str, rel: str) -> list:
    out = []
    for node in ast.walk(ast.parse(source, filename=rel)):
        if isinstance(node, ast.Call):
            name = _banned_call(node.func)
            if name is not None:
                out.append(f"{rel}:{node.lineno}: model code calls aggregation "
                           f"primitive `{name}` — go through core.message_passing "
                           "(mp_layer / MPSpec / the named aggregate helpers)")
    return out


def test_gnn_models_speak_the_contract():
    mods = sorted(GNN.rglob("*.py"))
    assert {p.name for p in mods} >= {"layers.py", "models.py"}
    errors = [e for p in mods for e in violations(p.read_text(), p.name)]
    assert errors == []


def test_guard_flags_primitive_calls():
    bad = (
        "from repro_torch.core.message_passing import gather_scatter\n"
        "from repro_torch.core import scatter_gather as sg\n"
        "from repro_torch.kernels import ops as kops\n"
        "def layer(g, msg, lay):\n"
        "    a = gather_scatter(g, msg)            # bare-name import\n"
        "    b = kops.segment_reduce(msg, lay.offsets, 8)\n"
        "    c = kops.edge_softmax(msg, lay.offsets, 8)\n"
        "    return sg.segment_sum(msg, lay.ids_sorted, 8), a, b, c\n"
    )
    errors = violations(bad, "rogue_model.py")
    for needle in ("gather_scatter", "segment_reduce", "edge_softmax", "segment_sum"):
        assert any(needle in e for e in errors), (needle, errors)
    assert len(errors) == 4


def test_guard_allows_the_contract_surface():
    ok = (
        "from repro_torch.core import message_passing as mp\n"
        "def layer(g, x, lay, spec, operands):\n"
        "    h = mp.mp_layer(g, x, spec=spec, operands=operands, layout=lay)\n"
        "    att = mp.gat_attention(g, x, x[:, None, :], layout=lay)\n"
        "    return mp.global_pool(g, h), att\n"
    )
    assert violations(ok, "fine_model.py") == []
