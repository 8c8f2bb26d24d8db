"""The port imports nothing of the JAX package, nor its benchmark script.

Every module of vector_store_tpu_torch/, and chip_smoke.py, is parsed with
`ast`; an `import vector_store_tpu...`, a `from vector_store_tpu... import`
or an `import_module("vector_store_tpu...")` that does not name
vector_store_tpu_torch fails, and so does any import of `bench` (the JAX
package's bench.py: the port keeps its own copy of the corpus recipe in
probes/data.py).  (That the port keeps `jax` itself out of
sys.modules is pinned by test_torch_service.py and test_torch_probes.py.)

The sharded classes drive the single-device indexes through their public
steps: no module under shard/ imports a `_`-prefixed name from core/.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = "vector_store_tpu_torch"
FILES = sorted(p.relative_to(ROOT).as_posix() for p in (ROOT / PORT).rglob("*.py"))
FILES.append("chip_smoke.py")


FORBIDDEN = ("vector_store_tpu", "bench")


def _jax_package(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def jax_package_imports(source: str) -> list[str]:
    """The imports of the JAX package or bench.py in `source`, as
    'line: name'."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            found += [f"{node.lineno}: {a.name}" for a in node.names if _jax_package(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _jax_package(node.module):
                found.append(f"{node.lineno}: {node.module}")
        elif isinstance(node, ast.Call):
            fn = node.func
            called = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if called in ("import_module", "__import__") and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    if _jax_package(arg.value):
                        found.append(f"{node.lineno}: {arg.value}")
    return found


@pytest.mark.parametrize("path", FILES)
def test_port_module_imports_nothing_of_the_jax_package(path):
    assert jax_package_imports((ROOT / path).read_text()) == []


@pytest.mark.parametrize(
    "source,want",
    [
        ("import vector_store_tpu\n", ["1: vector_store_tpu"]),
        ("import vector_store_tpu.types as t\n", ["1: vector_store_tpu.types"]),
        ("from vector_store_tpu.utils import metrics\n", ["1: vector_store_tpu.utils"]),
        ("from vector_store_tpu import config\n", ["1: vector_store_tpu"]),
        ("import importlib\nimportlib.import_module('vector_store_tpu.core')\n",
         ["2: vector_store_tpu.core"]),
        ("def f():\n    from vector_store_tpu.types import IndexParams\n",
         ["2: vector_store_tpu.types"]),
        ("from bench import make_dataset\n", ["1: bench"]),
        ("def f():\n    import bench\n", ["2: bench"]),
        ("import importlib\nimportlib.import_module('bench')\n", ["2: bench"]),
        ("import benchmark\nfrom .bench import x\nfrom .data import recall_of\n", []),
        ("import vector_store_tpu_torch\nfrom vector_store_tpu_torch.core import ivf\n"
         "from .types import IndexParams\nfrom ..utils import metrics\n", []),
    ],
)
def test_the_import_check_finds_what_it_must(source, want):
    assert jax_package_imports(source) == want


SHARD_FILES = [f for f in FILES if f.startswith(f"{PORT}/shard/")]


def private_core_imports(source: str) -> list[str]:
    """The `_`-prefixed names a module under shard/ imports from core/, as
    'line: module.name'."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if not isinstance(node, ast.ImportFrom) or not node.module:
            continue
        relative = node.level == 2 and node.module.split(".")[0] == "core"
        if relative or node.module.startswith(f"{PORT}.core"):
            found += [f"{node.lineno}: {node.module}.{a.name}" for a in node.names
                      if a.name.startswith("_")]
    return found


@pytest.mark.parametrize("path", SHARD_FILES)
def test_shard_modules_import_no_private_name_of_core(path):
    assert SHARD_FILES and private_core_imports((ROOT / path).read_text()) == []


@pytest.mark.parametrize(
    "source,want",
    [
        ("from ..core.ivf import IvfIndex, _from_numpy\n", ["1: core.ivf._from_numpy"]),
        ("def f():\n    from vector_store_tpu_torch.core.persist import _config\n",
         ["2: vector_store_tpu_torch.core.persist._config"]),
        ("from ..core.ivf import IvfIndex\nfrom .mesh import _helper\n", []),
    ],
)
def test_the_private_import_check_finds_what_it_must(source, want):
    assert private_core_imports(source) == want
