"""Every public name of limg_tpu has its counterpart in limg_tpu_torch.

For each module of the JAX package, except the TPU kernels
(``pallas_kernels/``) and the test-only NumPy oracle ``golden.py``, every
top-level function and class without a leading underscore must be defined
by the port's module of the same path (a def, a class, an assignment or an
import), or stand in ``ELSEWHERE`` with the port's name that takes its
place, or in ``TPU_ONLY`` with the reason the port does without it. Both
packages are read as source (``ast``), not imported, so the check costs
nothing.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = ROOT / "limg_tpu", ROOT / "limg_tpu_torch"

# JAX name -> the port's counterpart under another name, as module.name
ELSEWHERE = {
    "encoder.encode_perf_step_pallas": "encoder.encode_perf_step",
    "ops.segments.seg_mixed_all_jnp": "ops.segments.seg_mixed_all",
}
# JAX name -> why the port has none (ROADMAP.md, "What the port does not
# carry over")
TPU_ONLY = {
    "ops.layout.host_block_view": "a host-side 4-D view of the image that spares XLA's "
                                  "(8, 128) re-tiling pass on the TPU; the port blockifies "
                                  "on the card",
}


def _modules():
    for path in sorted(JAX_PKG.rglob("*.py")):
        rel = path.relative_to(JAX_PKG)
        if rel.parts[0] != "pallas_kernels" and rel.name != "golden.py":
            yield rel


def _dotted(rel: Path) -> str:
    return ".".join(rel.with_suffix("").parts)


def _public(path: Path) -> list[str]:
    tree = ast.parse(path.read_text())
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not n.name.startswith("_")]


def _defined(path: Path) -> set[str]:
    """Top-level names a module binds: defs, classes, assignments, imports."""
    names = set()
    if not path.exists():
        return names
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names.update(t.id for t in targets if isinstance(t, ast.Name))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
    return names


def _port_path(module: str) -> Path:
    return PORT_PKG / (module.replace(".", "/") + ".py")


@pytest.mark.parametrize("rel", list(_modules()), ids=_dotted)
def test_module_has_every_public_name(rel):
    module = _dotted(rel)
    port = _defined(PORT_PKG / rel)
    missing = [name for name in _public(JAX_PKG / rel)
               if name not in port and f"{module}.{name}" not in ELSEWHERE
               and f"{module}.{name}" not in TPU_ONLY]
    assert not missing, f"limg_tpu_torch/{rel} lacks {missing}"


@pytest.mark.parametrize("name", sorted(ELSEWHERE))
def test_each_counterpart_exists(name):
    module, _, attr = ELSEWHERE[name].rpartition(".")
    assert attr in _defined(_port_path(module)), ELSEWHERE[name]


@pytest.mark.parametrize("name", sorted({**ELSEWHERE, **TPU_ONLY}))
def test_table_entries_are_needed(name):
    """Each table entry names a public JAX name the port's module lacks."""
    module, _, attr = name.rpartition(".")
    assert attr in _public(JAX_PKG / (module.replace(".", "/") + ".py")), name
    assert attr not in _defined(_port_path(module)), f"{name} is in the port: drop its entry"
