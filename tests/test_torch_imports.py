"""The PyTorch port imports neither JAX nor the JAX package.

A fresh interpreter imports every module of ``repro_torch`` (the CUDA
kernels are built on first launch, never at import) and must leave
``jax`` and ``repro`` out of ``sys.modules``.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

pytestmark = pytest.mark.torch

SRC = Path(__file__).resolve().parent.parent / "src"

PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch."))
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_reference():
    import json
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", PROBE], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["bad"] == []
    for name in ("repro_torch.core.engine", "repro_torch.core.schedulers",
                 "repro_torch.kernels.sched_argmin",
                 "repro_torch.kernels.build", "repro_torch.interop",
                 "repro_torch.launch.experiment",
                 "repro_torch.configs.base",
                 "repro_torch.configs.qwen2_1_5b",
                 "repro_torch.configs.deepseek_moe_16b",
                 "repro_torch.models.layers", "repro_torch.models.attention",
                 "repro_torch.models.transformer", "repro_torch.models.moe",
                 "repro_torch.models.model",
                 "repro_torch.kernels.flash_attention",
                 "repro_torch.kernels.grouped_matmul",
                 "repro_torch.core.ref_engine", "repro_torch.core.metrics",
                 "repro_torch.serving", "repro_torch.serving.engine"):
        assert name in result["modules"]


def test_port_sources_name_no_reference_module():
    """No source file of the port imports from ``repro`` or ``jax``."""
    offenders = []
    for path in (SRC / "repro_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import jax", "from jax", "import repro.",
                             "from repro.", "from repro import",
                             "import repro ")):
                offenders.append(f"{path.name}: {s}")
    assert offenders == []
