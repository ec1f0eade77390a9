"""The port imports without jax: its serving module, models and kernel
wrappers load in a fresh interpreter with ``ALPRO_PLATFORM`` unset, and
neither jax, flax, optax nor PIL is imported (the machine with the GPU has
none of them), and no kernel is built at import."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_PROBE = """
import sys
import alpro_tpu_torch.serving.retrieval
import alpro_tpu_torch.models.alpro
import alpro_tpu_torch.checkpoint.load
import alpro_tpu_torch.ops.qkv_attn, alpro_tpu_torch.ops.ln_mlp
import alpro_tpu.data.tokenization
heavy = sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'flax', 'optax', 'PIL'})
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
