"""The quality gate's "dp" recipe from several initialisations: how far its
0.82 floor depends on the draw of bert-tiny's initial weights.

    python3 gate_spread.py port cuda:0:bf16 cpu:0:bf16 cuda:1:bf16        # the port, on the card
    python3 gate_spread.py port --cpu cpu:0:bf16 cpu:1:bf16               # the port, on the CPU
    JAX_PLATFORMS=cpu python3 gate_spread.py jax 0:bf16 1:bf16            # JAX's own script, keys 0 and 1

Each case of the port is ``INIT_DEVICE:SEED:MIXED_PRECISION``: the model
is `create_bert_model(seed=SEED)` drawn on INIT_DEVICE's generator, then
moved to the run's device, and trained by
`accelerate_tpu_torch/test_utils/scripts/test_performance.py`'s recipe
(`text_pair`, 14 epochs). JAX's case is ``KEY:MIXED_PRECISION``: its
`accelerate_tpu/test_utils/scripts/test_performance.py` with
`create_bert_model(rng=jax.random.key(KEY))`. One JSON line a case
(``accuracy``, ``final_loss``, ``seconds``), the floor not applied.
"""

import json
import sys
import time


def port_case(case: str, cpu: bool) -> dict:
    import accelerate_tpu_torch.models as models
    from accelerate_tpu_torch.state import AcceleratorState, GradientState
    from accelerate_tpu_torch.test_utils.scripts import test_performance

    init_device, seed, mixed_precision = case.split(":")
    real = models.create_bert_model

    def create(config, device=None, **kwargs):
        return real(config, seed=int(seed), device=init_device).to(device)

    models.create_bert_model = create
    AcceleratorState._reset_state()
    GradientState._reset_state()
    t0 = time.perf_counter()
    try:
        result = test_performance.main(["--mixed_precision", mixed_precision, "--performance_lower_bound", "0.0",
                                        *(["--cpu"] if cpu else [])])
    finally:
        models.create_bert_model = real
    return dict(side="port", init_device=init_device, seed=int(seed), mixed_precision=mixed_precision,
                accuracy=result["accuracy"], final_loss=result["final_loss"], seconds=time.perf_counter() - t0)


def jax_case(case: str) -> dict:
    import jax

    import accelerate_tpu.models as models
    from accelerate_tpu.test_utils.scripts import test_performance

    key, mixed_precision = case.split(":")
    real = models.create_bert_model

    def create(config, seq_len=128, **kwargs):
        return real(config, rng=jax.random.key(int(key)), seq_len=seq_len)

    models.create_bert_model = create
    t0 = time.perf_counter()
    try:
        result = test_performance.main(["--mixed_precision", mixed_precision, "--performance_lower_bound", "0.0"])
    finally:
        models.create_bert_model = real
    return dict(side="jax", key=int(key), mixed_precision=mixed_precision, accuracy=result["accuracy"],
                final_loss=result["final_loss"], seconds=time.perf_counter() - t0)


def main(argv) -> int:
    if not argv or argv[0] not in ("port", "jax"):
        print(__doc__, file=sys.stderr)
        return 2
    side, rest = argv[0], argv[1:]
    cpu = "--cpu" in rest
    for case in (c for c in rest if c != "--cpu"):
        row = port_case(case, cpu) if side == "port" else jax_case(case)
        print("[spread] " + json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
