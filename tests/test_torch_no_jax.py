"""The port stands alone: no module of ``alpro_tpu_torch`` and neither
``chip_smoke.py``, ``profile_serving.py`` nor ``profile_train.py`` imports jax or anything of the JAX package ``alpro_tpu``
(not even a module there that does not import jax), anywhere in its source —
including imports inside functions, which only an AST scan sees. And the
port loads in a fresh interpreter with ``ALPRO_PLATFORM`` unset without
importing jax, flax, optax, PIL or ``alpro_tpu`` (the machine with the GPU
has none of the first four), and builds no kernel at import."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
_FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "alpro_tpu"}
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
heavy = sorted({m.split('.')[0] for m in sys.modules}
               & {'jax', 'flax', 'optax', 'PIL', 'alpro_tpu'})
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
