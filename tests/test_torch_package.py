"""Package-level rules of the PyTorch/CUDA port (`accelerate_tpu_torch`).

  - it imports nothing of JAX (jax, flax, optax) and nothing of the JAX
    package, at run time (a fresh interpreter) and in its source (an AST
    scan);
  - its entry points run on the card unless the caller asks for the CPU;
  - importing the kernel modules builds nothing, and CPU tensors never reach
    the build;
  - the kernels build for Hopper (sm_90a) from the package's own sources.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import accelerate_tpu_torch
from accelerate_tpu_torch.ops import _build
from accelerate_tpu_torch.ops import paged_attention as port_paged

torch.set_num_threads(2)

PACKAGE = Path(accelerate_tpu_torch.__file__).parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "accelerate_tpu")


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_import_loads_no_jax_module():
    code = (
        "import json, sys\n"
        "import accelerate_tpu_torch, accelerate_tpu_torch.serving, accelerate_tpu_torch.ops.paged_attention\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, check=True,
        cwd=PACKAGE.parent, timeout=120,
    )
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "accelerate_tpu_torch" in loaded
    assert not [m for m in loaded if _forbidden(m)]


def test_source_imports_no_jax_module():
    found = []
    for path in sorted(PACKAGE.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [f"{path.name}:{node.lineno} {n}" for n in names if _forbidden(n)]
    assert not found


def test_entry_points_default_to_the_card(monkeypatch):
    """No GPU and no explicit device: raise, never fall back to the CPU."""
    from accelerate_tpu_torch import ContinuousBatcher, create_llama_model, resolve_device
    from accelerate_tpu_torch.models import llama_tiny

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_llama_model(llama_tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    model = create_llama_model(llama_tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousBatcher(model)
    assert resolve_device("cpu") == torch.device("cpu")


def test_cpu_calls_never_build(monkeypatch):
    """The kernel modules import without nvcc, and a CPU tensor takes the
    plain version without touching the build."""
    def no_build(*args, **kwargs):
        raise AssertionError("a CPU call reached the kernel build")

    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(_build, "load", no_build)
    q = torch.randn(2, 1, 4, 8)
    pool = torch.randn(5, 4, 2, 8)
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    pos = torch.tensor([[5], [2]], dtype=torch.int32)
    out = port_paged.paged_decode_attention(q, pool, pool, table, pos)
    assert out.shape == q.shape and torch.isfinite(out).all()
    assert _build._LIBS == {}


def test_build_targets_hopper_from_package_sources():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    sources = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    assert sources == ["paged_attention.cu"]
    path = _build.library_path("paged_attention")
    assert path.parent == _build.BUILD_DIR and path.name.startswith("paged_attention-")
    assert _build.BUILD_DIR.parts[-2] == "build", "the build lands under the ignored build/"
    text = (_build.CSRC / "paged_attention.cu").read_text()
    assert "accelerate_tpu/ops/paged_attention.py::_decode_kernel" in text
    for entry in ("paged_decode_launch", "paged_verify_launch"):
        assert f'extern "C" int {entry}' in text
