"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on the card unless the caller asks for the CPU."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

# The shapes here are tiny: torch's intra-op threads only contend with the
# other test workers for the cores (one step of the tiny Llama runs ~17x
# slower on 8 threads than on 1), so every op runs on the calling thread.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "torchft_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "torchft_tpu")


def _port_sources():
    return sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_importing_every_module_leaves_jax_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import torchft_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad or len(names) < 8 else 0)\n" % (FORBIDDEN,)
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_source_file_imports_jax_or_the_jax_package(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_default_device_is_the_card_and_never_the_cpu(monkeypatch):
    from torchft_tpu_torch.models.llama import CONFIGS, Llama
    from torchft_tpu_torch.utils import platform

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Llama(CONFIGS["tiny"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Llama(CONFIGS["tiny"], device="cuda")
    assert not platform.is_hopper()
    assert next(Llama(CONFIGS["tiny"], device="cpu").parameters()).device.type == "cpu"


def test_unported_options_raise():
    from dataclasses import replace

    from torchft_tpu_torch.models.llama import CONFIGS, Llama

    for fields in ({"attention_impl": "ring"}, {"attention_impl": "blockwise"}, {"remat": "dots"}):
        with pytest.raises(NotImplementedError):
            Llama(replace(CONFIGS["tiny"], **fields), device="cpu")


def test_kernel_sources_ship_with_the_package():
    assert (PACKAGE / "csrc" / "flash_attention.cu").is_file()
    text = (REPO / "pyproject.toml").read_text()
    assert '"torchft_tpu_torch" = ["csrc/*.cu"]' in text


def test_kernel_build_without_nvcc_raises_and_leaves_nothing(monkeypatch, tmp_path):
    """A missing compiler is an error, never a quiet switch to the plain
    versions."""
    from torchft_tpu_torch import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library("flash_attention")
    assert "flash_attention" not in _build._loaded
    assert not (tmp_path / "kernels").exists()
