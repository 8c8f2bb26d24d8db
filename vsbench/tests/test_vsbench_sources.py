"""What the benchmark's sources import, and the reference against numpy."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from vsbench import judge
from vsbench.references import exact_cosine

HERE = Path(__file__).resolve().parent.parent
SOURCES = sorted(p.relative_to(HERE).as_posix() for p in HERE.rglob("*.py"))
REFERENCES = sorted(p.relative_to(HERE).as_posix() for p in (HERE / "references").glob("*.py"))
CORPORA = sorted(p.relative_to(HERE).as_posix() for p in (HERE / "corpora").glob("*.py"))


def imported(source: str) -> set[str]:
    """Top-level names of every module `source` imports (absolute imports,
    and import_module / __import__ calls with a constant name)."""
    names = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call):
            fn = node.func
            called = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if called in ("import_module", "__import__") and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    names.add(arg.value.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES)
def test_no_source_imports_jax_or_the_jax_package(path):
    found = imported((HERE / path).read_text()) & {"jax", "jaxlib", "flax", "vector_store_tpu"}
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("path", REFERENCES)
def test_the_reference_imports_nothing_of_the_program(path):
    names = imported((HERE / path).read_text())
    assert "vector_store_tpu_torch" not in names
    assert names <= {"__future__", "torch", "numpy", "math"}, names


@pytest.mark.parametrize("path", CORPORA)
def test_a_corpus_imports_torch_and_numpy_alone(path):
    names = imported((HERE / path).read_text())
    assert names <= {"__future__", "torch", "numpy"}, names


def test_the_import_check_compares_whole_top_level_names():
    src = ("import vector_store_tpu_torch\nfrom vector_store_tpu_torch.core import ivf\n"
           "import jaxtyping\nimport importlib\nimportlib.import_module('jax.numpy')\n")
    assert imported(src) == {"vector_store_tpu_torch", "jaxtyping", "importlib", "jax"}


def test_reference_topk_equals_a_numpy_brute_force():
    rng = np.random.default_rng(5)
    rows = rng.standard_normal((700, 24)).astype(np.float32)
    queries = rng.standard_normal((33, 24)).astype(np.float32)
    saved = exact_cosine.BLOCK
    exact_cosine.BLOCK = 128  # several blocks and a short last one
    try:
        d, i = exact_cosine.topk(torch.from_numpy(rows), torch.from_numpy(queries), 7)
    finally:
        exact_cosine.BLOCK = saved
    xn = rows / np.linalg.norm(rows, axis=1, keepdims=True)
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    full = 1.0 - qn.astype(np.float64) @ xn.T.astype(np.float64)
    want = np.argsort(full, axis=1, kind="stable")[:, :7]
    assert np.array_equal(i.numpy(), want)
    np.testing.assert_allclose(d.numpy(), np.take_along_axis(full, want, 1), atol=1e-6)
    pd = exact_cosine.pair_distances(torch.from_numpy(rows), torch.from_numpy(queries),
                                     torch.arange(33), i, block=5)
    np.testing.assert_allclose(pd.numpy(), np.take_along_axis(full, want, 1), atol=1e-6)
    # the same through the reference's interface (vsbench/judge.py): the exact
    # ids, and dist_gap of answers that give numpy's distances
    rows_t, queries_t = torch.from_numpy(rows), torch.from_numpy(queries)
    exact = exact_cosine.exact(rows_t, queries_t, 7)
    assert np.array_equal(exact.numpy(), want)
    judged = judge.Judged(np.arange(33), want, np.take_along_axis(full, want, 1).astype(np.float32), 0)
    assert exact_cosine.compared(rows_t, queries_t, judged, exact)["dist_gap"] <= 1e-6
