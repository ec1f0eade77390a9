"""The port stands alone: no module of ``alpro_tpu_torch`` and neither
``chip_smoke.py``, ``profile_serving.py`` nor ``profile_train.py`` imports jax or anything of the JAX package ``alpro_tpu``
(not even a module there that does not import jax), anywhere in its source —
including imports inside functions, which only an AST scan sees. No port
module imports PIL or pandas at module level (the machine with the GPU has
neither; an optional dependency is imported inside the function that needs
it, as ``transformers`` is). And the port loads in a fresh interpreter with
``ALPRO_PLATFORM`` unset without importing jax, flax, optax, PIL, pandas,
``transformers`` or ``alpro_tpu`` (the machine with the GPU has none of the
first six), and builds no kernel at import."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
_FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "alpro_tpu"}
_NOT_AT_MODULE_LEVEL = {"PIL", "pandas"}
_SOURCES = sorted((REPO / "alpro_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "profile_serving.py", REPO / "profile_train.py"]


def _imported_roots(path: Path):
    """(line, top-level module) of every absolute import in ``path``."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]


def _module_level_roots(path: Path):
    """(line, top-level module) of every absolute import that runs when
    ``path`` is imported: not inside a function or lambda body."""
    def walk(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            if isinstance(child, ast.Import):
                for alias in child.names:
                    yield child.lineno, alias.name.split(".")[0]
            elif isinstance(child, ast.ImportFrom) and child.level == 0 and child.module:
                yield child.lineno, child.module.split(".")[0]
            yield from walk(child)

    return list(walk(ast.parse(path.read_text(), filename=str(path))))


_PORT = sorted((REPO / "alpro_tpu_torch").rglob("*.py"))


@pytest.mark.parametrize("path", _PORT, ids=lambda p: str(p.relative_to(REPO)))
def test_module_imports_no_pil_or_pandas_at_module_level(path):
    bad = [f"{path.relative_to(REPO)}:{line} imports {root} at module level"
           for line, root in _module_level_roots(path) if root in _NOT_AT_MODULE_LEVEL]
    assert not bad, bad


def test_module_level_scan_skips_function_bodies(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import PIL.Image\ntry:\n    import pandas\nexcept ImportError:\n"
                     "    pass\nclass A:\n    import numpy\ndef f():\n    import torch\n")
    assert sorted(r for _, r in _module_level_roots(probe)) == ["PIL", "numpy", "pandas"]


def test_the_scans_cover_the_eval_path_modules():
    """The new packages of the eval, finetuning and pretraining paths are
    under the scans' ``rglob``."""
    names = {str(p.relative_to(REPO / "alpro_tpu_torch")) for p in _PORT}
    assert {"core/config.py", "core/logging.py", "data/tokenization.py", "data/transforms.py",
            "data/datasets.py", "data/loader.py", "media/__init__.py", "cli/common.py",
            "cli/run_video_retrieval.py", "cli/run_video_qa.py", "evals/retrieval.py",
            "checkpoint/reference.py", "checkpoint/restore.py", "core/misc.py",
            "models/remat.py", "data/masking.py", "data/randaugment.py", "objectives/mlm.py",
            "objectives/pem.py", "checkpoint/visual_init.py", "cli/prompts.py",
            "cli/run_pretrain.py", "cli/run_prompter.py"} <= names
    assert set(_PORT) <= set(_SOURCES)


@pytest.mark.parametrize("path", _SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_nothing_of_jax(path):
    bad = [f"{path.relative_to(REPO)}:{line} imports {root}"
           for line, root in _imported_roots(path) if root in _FORBIDDEN]
    assert not bad, bad


def test_scan_sees_imports_inside_functions(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("def f():\n    from alpro_tpu.checkpoint import export_torch\n"
                     "import alpro_tpu_torch.ops\n")
    assert sorted(r for _, r in _imported_roots(probe)) == ["alpro_tpu", "alpro_tpu_torch"]


_PROBE = """
import sys
import alpro_tpu_torch.serving.retrieval, alpro_tpu_torch.serving.qa
import alpro_tpu_torch.models.alpro
import alpro_tpu_torch.checkpoint.load, alpro_tpu_torch.checkpoint.from_jax
import alpro_tpu_torch.evals.qa
import alpro_tpu_torch.ops.qkv_attn, alpro_tpu_torch.ops.ln_mlp, alpro_tpu_torch.ops.bert_block
import alpro_tpu_torch.ops.masked_attn, alpro_tpu_torch.ops.attention, alpro_tpu_torch.ops.layers
import alpro_tpu_torch.ops.ln_matmul, alpro_tpu_torch.ops.preprocess, alpro_tpu_torch.ops.fused_block
import alpro_tpu_torch.ops.layernorm, alpro_tpu_torch.ops.temporal_attn, alpro_tpu_torch.ops.block_attn
import alpro_tpu_torch.objectives.vtc, alpro_tpu_torch.objectives.vtm
import alpro_tpu_torch.train.optimizer, alpro_tpu_torch.train.state, alpro_tpu_torch.train.step
import alpro_tpu_torch.cli.run_video_retrieval, alpro_tpu_torch.cli.run_video_qa
import alpro_tpu_torch.checkpoint.reference, alpro_tpu_torch.evals.retrieval
import alpro_tpu_torch.data.loader, alpro_tpu_torch.data.transforms
import alpro_tpu_torch.checkpoint.restore, alpro_tpu_torch.core.misc, alpro_tpu_torch.models.remat
import alpro_tpu_torch.cli.run_pretrain, alpro_tpu_torch.cli.run_prompter
import alpro_tpu_torch.data.randaugment, alpro_tpu_torch.checkpoint.visual_init
heavy = sorted({m.split('.')[0] for m in sys.modules}
               & {'jax', 'flax', 'optax', 'PIL', 'pandas', 'alpro_tpu', 'transformers'})
from alpro_tpu_torch.ops import _build
assert _build._lib is None, 'kernel library loaded at import'
print('HEAVY', heavy)
"""


def test_port_imports_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "ALPRO_PLATFORM"}
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "HEAVY []" in out.stdout, out.stdout
