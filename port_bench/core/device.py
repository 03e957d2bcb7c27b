"""The card a run measures on: its name, count and memory, and
``nvidia-smi``'s readings of clocks, temperature and power beside the
window."""

from __future__ import annotations

import json
import os
import subprocess
from pathlib import Path

SMI_FIELDS = "name,power.limit,clocks.sm,temperature.gpu,power.draw"


def smi_index() -> str:
    """``nvidia-smi``'s index of the run's first card: the first entry of
    ``CUDA_VISIBLE_DEVICES`` where that names one, else 0."""
    vis = os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")[0].strip()
    return vis if vis.isdigit() else "0"


def smi_sample() -> dict:
    """One reading of the card by ``nvidia-smi``, or the reason there is
    none."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={SMI_FIELDS}",
             "--format=csv,noheader", "-i", smi_index()],
            capture_output=True, text=True, timeout=20, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return {"nvidia_smi": f"unavailable: {e}"}
    return dict(zip(SMI_FIELDS.split(","), [v.strip() for v in out.split(",")]))


def peaks(root: Path, kind: str) -> dict | None:
    """The card's published peaks from ``peaks.json``, by its name."""
    with open(Path(root) / "port_bench" / "peaks.json") as f:
        table = json.load(f)
    return table["cards"].get(kind)


def describe(torch, device, chips: int) -> dict:
    """The result line's ``device`` object, without the peak memory."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips}
