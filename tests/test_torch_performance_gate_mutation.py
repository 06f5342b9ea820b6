"""The port's quality gate binds: JAX's mutation audit
(`tests/test_integration_gates.py::test_mutation_wrong_lr_fails_gate`,
which JAX runs only under ``ACCELERATE_TPU_RUN_MUTATION``), here in tier-1.
A 10x learning rate (3e-3) never leaves the ln(2) saddle of the
`text_pair` task, so the full recipe's "dp" run must fail the 0.82 floor.
About 140 s (14 epochs of bert-tiny in bf16 on two threads).
"""

import pytest
import torch

from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.test_utils.scripts import test_performance as gate


@pytest.fixture(autouse=True)
def two_threads_one_process(monkeypatch):
    for key in ("ACCELERATE_TPU_MIXED_PRECISION", "ACCELERATE_TPU_GRADIENT_ACCUMULATION_STEPS"):
        monkeypatch.delenv(key, raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    yield
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    torch.set_num_threads(threads)


def test_mutation_wrong_lr_fails_gate(capsys):
    with pytest.raises(AssertionError, match="accuracy gate FAILED for dp"):
        gate.main(["--cpu", "--lr", "3e-3"])
    assert "Performance gate passed" not in capsys.readouterr().out
