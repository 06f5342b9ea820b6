"""Package-level rules of the PyTorch/CUDA port (`accelerate_tpu_torch`).

  - it imports nothing of JAX (jax, flax, optax, ml_dtypes), nothing of the
    JAX package and neither `safetensors` nor `transformers` (the chip
    machine has none of them), at run time (a fresh interpreter) and in its
    source (an AST scan);
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
from accelerate_tpu_torch.ops import flash_attention as port_flash
from accelerate_tpu_torch.ops import paged_attention as port_paged
from accelerate_tpu_torch.ops import quantization as port_quant

torch.set_num_threads(2)

PACKAGE = Path(accelerate_tpu_torch.__file__).parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "safetensors", "transformers", "accelerate_tpu")


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_import_loads_no_jax_module():
    code = (
        "import json, sys\n"
        "import accelerate_tpu_torch, accelerate_tpu_torch.serving, accelerate_tpu_torch.ops.paged_attention\n"
        "import accelerate_tpu_torch.accelerator, accelerate_tpu_torch.train_step, accelerate_tpu_torch.utils\n"
        "import accelerate_tpu_torch.ops.flash_attention, accelerate_tpu_torch.ops.quantization\n"
        "import accelerate_tpu_torch.utils.operations, accelerate_tpu_torch.generation\n"
        "import accelerate_tpu_torch.ops.remat, accelerate_tpu_torch.tracking, accelerate_tpu_torch.models.bert\n"
        "import accelerate_tpu_torch.examples.nlp_example, accelerate_tpu_torch.models.decoder\n"
        "import accelerate_tpu_torch.models.gpt_neox, accelerate_tpu_torch.models.gptj, accelerate_tpu_torch.models.opt\n"
        "import accelerate_tpu_torch.models.t5, accelerate_tpu_torch.utils.hf_loading, accelerate_tpu_torch.utils.modeling\n"
        "import accelerate_tpu_torch.parallel.expert, accelerate_tpu_torch.models.mixtral\n"
        "import accelerate_tpu_torch.telemetry, accelerate_tpu_torch.analysis.trace_guard\n"
        "import accelerate_tpu_torch.test_utils.analysis_fixtures\n"
        "import accelerate_tpu_torch.launchers, accelerate_tpu_torch.parallel.fsdp, accelerate_tpu_torch.parallel.mesh\n"
        "import accelerate_tpu_torch.parallel.sharding, accelerate_tpu_torch.ops.losses, accelerate_tpu_torch.state\n"
        "import accelerate_tpu_torch.utils.constants, accelerate_tpu_torch.data_loader, accelerate_tpu_torch.checkpointing\n"
        "import accelerate_tpu_torch.logging, accelerate_tpu_torch.scheduler, accelerate_tpu_torch.utils.memory\n"
        "import accelerate_tpu_torch.utils.random, accelerate_tpu_torch.utils.imports, accelerate_tpu_torch.utils.tqdm\n"
        "import accelerate_tpu_torch.examples.cv_example, accelerate_tpu_torch.examples.by_feature.memory\n"
        "import accelerate_tpu_torch.examples.by_feature.early_stopping, accelerate_tpu_torch.examples.by_feature.tracking\n"
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
    from accelerate_tpu_torch import Accelerator, ContinuousBatcher, create_llama_model, create_named_model, resolve_device
    from accelerate_tpu_torch.models import llama_tiny
    from accelerate_tpu_torch.state import AcceleratorState

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_llama_model(llama_tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    model = create_llama_model(llama_tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousBatcher(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_named_model("gpt-neox-tiny")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_named_model("t5-tiny")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_named_model("mixtral-tiny")
    from accelerate_tpu_torch import Seq2SeqGenerator

    with pytest.raises(RuntimeError, match="device='cpu'"):
        Seq2SeqGenerator(create_named_model("t5-tiny", device="cpu"))
    AcceleratorState._reset_state()
    try:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Accelerator()
        AcceleratorState._reset_state()
        assert Accelerator(cpu=True).device == torch.device("cpu")
    finally:
        AcceleratorState._reset_state()
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
    codes, scales = port_quant.quantize_kv_pages(pool, port_quant.kv_quant_spec("int8"))
    out = port_paged.paged_decode_attention(q, codes, codes, table, pos, k_scale=scales, v_scale=scales)
    assert out.shape == q.shape and torch.isfinite(out).all()
    x = torch.randn(1, 128, 2, 32, requires_grad=True)
    port_flash.flash_attention(x, x, x, causal=True).sum().backward()
    assert x.grad.shape == x.shape
    assert _build._LIBS == {}


SOURCES = {
    "flash_attention.cu": (
        ["accelerate_tpu/ops/flash_attention.py::_fwd_kernel",
         "accelerate_tpu/ops/flash_attention.py::_bwd_dkv_kernel",
         "accelerate_tpu/ops/flash_attention.py::_bwd_dq_kernel"],
        ["flash_fwd_launch", "flash_bwd_dkv_launch", "flash_bwd_dq_launch"],
    ),
    "paged_attention.cu": (
        ["accelerate_tpu/ops/paged_attention.py::_decode_kernel"],
        ["paged_decode_launch", "paged_verify_launch", "paged_decode_quant_launch",
         "paged_verify_quant_launch"],
    ),
}


def test_build_targets_hopper_from_package_sources():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    sources = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    assert sources == sorted(SOURCES)
    assert _build.BUILD_DIR.parts[-2] == "build", "the build lands under the ignored build/"
    for source, (replaces, entries) in SOURCES.items():
        name = source[: -len(".cu")]
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR and path.name.startswith(f"{name}-")
        text = (_build.CSRC / source).read_text()
        for tpu_kernel in replaces:
            assert tpu_kernel in text, (source, tpu_kernel)
        for entry in entries:
            assert f'extern "C" int {entry}' in text, (source, entry)
