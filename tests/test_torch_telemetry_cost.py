"""`telemetry_cost.py`, the always-on telemetry priced against another
tree: each cell rehearsed on the CPU at `llama-tiny` size through the
entry points a user calls, the summary's ratios and equality checks, and
the refusals without a card. The measurement itself runs on the card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import telemetry_cost as tc

torch.set_num_threads(2)

TINY = dict(
    engine=dict(model_name="llama-tiny", engine_kw=dict(num_slots=2, page_size=8, max_length=256, chunk_size=4),
                n_requests=4, system_len=16, max_prompt=64, runs=2),
    training=dict(model_name="llama-tiny", seq=32, warmup=2, timed=4),
)
ROOT = Path(tc.__file__).resolve().parent


@pytest.fixture(scope="module")
def side():
    return tc.measure_side(torch.device("cpu"), **TINY)


def test_a_side_times_both_cells_as_a_user_calls_them(side):
    engine, training = side["engine"], side["training"]
    assert side["package"] == str(ROOT / "accelerate_tpu_torch")
    assert len(engine["decode_tokens_per_s"]) == len(engine["ttft_p50_s"]) == 2
    assert all(x > 0 for x in engine["decode_tokens_per_s"] + engine["ttft_p50_s"])
    assert len(engine["tokens_sha256"]) == 1  # both runs served the same tokens
    # This tree's train_step() is instrumented: the bare step under it takes
    # its turns a b b a after the warm-up.
    assert training["instrumented"]
    assert training["order"] == ["user", "user", "user", "bare", "bare", "user"]
    assert len(training["step_ms"]["user"]) == len(training["step_ms"]["bare"]) == 2
    losses = training["losses"]
    assert len(losses) == 6 and all(b < a for a, b in zip(losses, losses[1:]))


def test_summary_ratios_and_equality_checks(side):
    other = json.loads(json.dumps(side))
    other["training"] = {"step_ms": {"user": [2 * x for x in side["training"]["step_ms"]["user"]]},
                         "losses": side["training"]["losses"], "instrumented": False}
    other["engine"]["decode_tokens_per_s"] = [x / 2 for x in side["engine"]["decode_tokens_per_s"]]
    summary = tc.summarize({"other": [other, other], "this": [side, side]})
    assert summary["this_over_other"]["decode_tokens_per_s"] == pytest.approx(2.0)
    assert summary["this_over_other"]["step_ms"] == pytest.approx(0.5)
    assert summary["this_over_other"]["ttft_p50_s"] == pytest.approx(1.0)
    assert summary["tokens_equal_across_sides"] and summary["losses_bit_for_bit_across_processes"]
    assert summary["this"]["bare_step_ms_per_process"] == [tc._median(side["training"]["step_ms"]["bare"])] * 2
    assert summary["other"]["bare_step_ms_median"] is None
    other["engine"]["tokens_sha256"] = ["another"]
    other["training"]["losses"] = [x + 1 for x in side["training"]["losses"]]
    summary = tc.summarize({"other": [other], "this": [side]})
    assert not summary["tokens_equal_across_sides"] and not summary["losses_bit_for_bit_across_processes"]


@pytest.mark.parametrize("args", [["--other", str(ROOT)], ["--side", str(ROOT), "--json", "unused.json"]],
                         ids=["pairing", "side"])
def test_without_a_card_it_fails_and_prints_no_result(args, tmp_path):
    proc = subprocess.run([sys.executable, str(ROOT / "telemetry_cost.py"), *args, "--out",
                           str(tmp_path / "cost.json")], capture_output=True, text=True, cwd=tmp_path, timeout=300,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0 and "CUDA card" in proc.stderr + proc.stdout
    assert not (tmp_path / "cost.json").exists() and not (tmp_path / "unused.json").exists()


def test_breakdown_variants_run_and_leave_the_instruments_as_they_were():
    from accelerate_tpu_torch.telemetry import metrics

    before = {(cls, name): getattr(cls, name) for cls, name in (
        (metrics.Counter, "inc"), (metrics.Gauge, "set"), (metrics.Histogram, "observe"))}
    result = tc.measure_breakdown(torch.device("cpu"), variants=("default", "both_off", "gc_off"), rounds=1,
                                  model_name="llama-tiny", engine_kw=TINY["engine"]["engine_kw"], n_requests=4,
                                  system_len=16, max_prompt=64)
    assert result["order"] == ["default", "both_off", "gc_off", "gc_off", "both_off", "default"]
    for runs in result["variants"].values():
        assert len(runs["decode_tokens_per_s"]) == len(runs["chunk_ms"]) == 2
        assert all(x > 0 for x in runs["decode_tokens_per_s"] + runs["chunk_ms"])
    assert all(getattr(cls, name) is fn for (cls, name), fn in before.items())
    counter = metrics.MetricsRegistry().counter("c")
    counter.inc(2)
    assert counter.value == 2
    import gc

    assert gc.isenabled()
