"""The example-drift check (the port of `accelerate_tpu/test_utils/examples.py`,
itself the parity of Accelerate's `test_utils/examples.py:63`
`compare_against_test`).

Every `by_feature/*` twin stays a copy of the canonical example plus ONE
feature, checked structurally: it (a) reuses the canonical data pipeline by
importing `get_dataset` from the nlp example (JAX's scripts import it from
``nlp_example``; the port's twins from
``accelerate_tpu_torch.examples.nlp_example``), (b) keeps the canonical
training shape (a `training_function` or `main`, an argparse entry under
``if __name__ == "__main__"``, the `prepare()` call) and (c) introduces its
feature, shown by its API markers appearing in the source.
"""

from __future__ import annotations

import ast
from pathlib import Path

#: The modules a twin may import the canonical `get_dataset` from.
CANONICAL_DATASET_MODULES = ("nlp_example", "accelerate_tpu_torch.examples.nlp_example")


def parse_example(path: str | Path):
    src = Path(path).read_text()
    return src, ast.parse(src)


def imports_canonical_dataset(tree: ast.Module) -> bool:
    """True if the script imports get_dataset (or the corpus helper) instead of
    redefining the data pipeline."""
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module in CANONICAL_DATASET_MODULES:
            if any(alias.name == "get_dataset" for alias in node.names):
                return True
    # Only genuinely different-domain scripts (pretraining corpora) may be
    # self-contained, and they must use the distinct `get_corpus` name: a local
    # `get_dataset` is exactly the copy-instead-of-import rot this check catches.
    return any(
        isinstance(node, ast.FunctionDef) and node.name == "get_corpus" for node in ast.walk(tree)
    )


def toplevel_function_names(tree: ast.Module) -> set:
    return {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}


def has_argparse_main(tree: ast.Module) -> bool:
    """The canonical entry shape: argparse wiring under `if __name__ == "__main__"`."""
    for node in tree.body:
        if isinstance(node, ast.If):
            test = ast.unparse(node.test).replace("'", '"')
            if test == '__name__ == "__main__"':
                return "ArgumentParser" in ast.unparse(node)
    return False


def check_example_shape(path: str | Path, feature_markers: list) -> list:
    """Return a list of drift problems (empty = conforming)."""
    src, tree = parse_example(path)
    problems = []
    if not imports_canonical_dataset(tree):
        problems.append("does not reuse the canonical dataset (import get_dataset from nlp_example)")
    if "training_function" not in toplevel_function_names(tree) and "main" not in toplevel_function_names(tree):
        problems.append("missing the canonical training_function/main entry")
    if not has_argparse_main(tree):
        problems.append("missing the canonical argparse __main__ block")
    if ".prepare(" not in src:
        problems.append("never calls accelerator.prepare()")
    missing = [m for m in feature_markers if m not in src]
    if missing:
        problems.append(f"feature marker(s) absent: {missing}")
    return problems
