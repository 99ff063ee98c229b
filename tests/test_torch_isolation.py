"""The PyTorch port stands alone: no JAX stack, nothing of ``art_sbir_tpu``,
no PIL, triton, pandas or matplotlib at import time (the card's host may
lack them), and no quiet fall back to the CPU."""

import argparse
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "art_sbir_tpu"}
PORT_FILES = sorted((ROOT / "art_sbir_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imports(tree):
    """(module name, node) for every import in the tree."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, node
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module, node


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_stack_or_jax_package_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [name for name, _ in _imports(tree)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_package_name_is_matched_exactly():
    """``art_sbir_tpu_torch`` itself is not the JAX package."""
    tree = ast.parse("import art_sbir_tpu_torch.ops\n"
                     "from art_sbir_tpu_torch import core\n"
                     "from art_sbir_tpu.ops import distance\n")
    names = [n.split(".")[0] for n, _ in _imports(tree)]
    assert [n in FORBIDDEN for n in names] == [False, False, True]


def test_pil_and_triton_only_inside_functions():
    for path in PORT_FILES:
        tree = ast.parse(path.read_text())
        for node in tree.body:  # module level only
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] if isinstance(
                    node, ast.Import) else [node.module or ""]
                assert not any(n.split(".")[0] in ("PIL", "triton", "pandas",
                                                   "matplotlib")
                               for n in names), path


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda, tmp_path):
    from art_sbir_tpu_torch.cli import inference, serve
    from art_sbir_tpu_torch.models.resnet import create_encoder
    from art_sbir_tpu_torch.retrieval.embed import embed_batched
    from art_sbir_tpu_torch.retrieval.engine import run_inference
    from art_sbir_tpu_torch.retrieval.rank import evaluate_retrieval
    from art_sbir_tpu_torch.retrieval.server import RetrievalEngine

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_encoder(layers=(1, 1, 1, 1), width=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RetrievalEngine(lambda x: x, np.zeros((2, 4), np.float32), ["a", "b"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        embed_batched(lambda x: x, np.zeros((2, 4, 4, 3), np.uint8))
    args = argparse.Namespace(folder="Run", features="cache",
                              results_root=str(tmp_path),
                              models_root=str(tmp_path),
                              feature_root=str(tmp_path), metric=None,
                              window_ms=1.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.build_engine(args)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.build_engine(serve.parse_args(["-f", "Run", "--features", "c"]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.build_engine(serve.parse_args(["-f", "Run"]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        inference.main(["--folder", "Run", "--results_root", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        inference.evaluate_folder("Run", tmp_path, tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_inference(lambda x: x, None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate_retrieval(np.zeros((1, 4), np.float32),
                           np.zeros((2, 4), np.float32), ["a-1.png"],
                           ["a.jpg", "b.jpg"])


def test_cpu_when_asked(no_cuda):
    from art_sbir_tpu_torch.core.device import resolve_device

    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(RuntimeError):
        resolve_device(None)


def test_chip_smoke_refuses_without_cuda(no_cuda, capsys):
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main([]) != 0
    assert '"ok": true' not in capsys.readouterr().out
