"""Nothing the harness or the reference imports is JAX or the JAX package:
each import of every module under perfbench/, by its top-level name
compared whole (esp_audio_libs_tpu_torch is the program and allowed)."""

from __future__ import annotations

import ast

from .conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "esp_audio_libs_tpu"}


def _tops(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted((REPO / "perfbench").rglob("*.py"))
    assert len(files) > 10
    found = {(str(p.relative_to(REPO)), t) for p in files for t in _tops(p) if t in FORBIDDEN}
    assert not found
    tops = {t for p in files for t in _tops(p)}
    assert "esp_audio_libs_tpu_torch" in tops


def test_the_check_compares_whole_names():
    assert "esp_audio_libs_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "esp_audio_libs_tpu.models".split(".")[0] in FORBIDDEN
    assert "jaxlib.xla_client".split(".")[0] in FORBIDDEN
