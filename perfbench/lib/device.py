"""The cards a run uses: the check that they are there, and what the result
line says of them."""

from __future__ import annotations

import shutil
import subprocess
from typing import Optional

import torch

from perfbench.lib.harness import HarnessError

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def require_chips(chips: int) -> None:
    """Raise unless torch sees at least ``chips`` CUDA cards: a run never
    falls back to the CPU."""
    if not torch.cuda.is_available():
        raise HarnessError("torch.cuda.is_available() is false: this benchmark runs on "
                           "CUDA cards only")
    n = torch.cuda.device_count()
    if n < chips:
        raise HarnessError(f"the cell asks for {chips} cards; torch sees {n}")


def power_limit_w() -> Optional[float]:
    """The card's power limit in W as nvidia-smi reads it (None where it
    cannot be read)."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        out = subprocess.run([smi, "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                              "-i", "0"], capture_output=True, text=True, timeout=20, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def device_report(chips: int, peak_bytes: int) -> dict:
    """The result line's ``device``: platform, the card's name, the cards
    used, the peak allocated bytes on the fullest card, the power limit."""
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": int(chips),
            "memory_peak_bytes": int(peak_bytes), "power_limit_w": power_limit_w()}


# device-neutral forms of the calls a driver makes, so that the CPU tests can
# drive the harness at a tiny size (a run itself never leaves the card)
def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def release(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.empty_cache()
