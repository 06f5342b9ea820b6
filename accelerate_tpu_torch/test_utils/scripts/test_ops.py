"""Collective-op correctness script (the port of
`accelerate_tpu/test_utils/scripts/test_ops.py`): `gather`,
`gather_object`, `broadcast`, `broadcast_object_list`, `reduce` and
`pad_across_processes` on the process's device, and debug mode's shape
check raising `DistributedOperationException` on every process when one
process's tensor is a row longer."""

import numpy as np
import torch


def gather_check(state):
    from accelerate_tpu_torch.utils import operations as ops

    local = torch.arange(4, dtype=torch.float32, device=state.device) + 10 * state.process_index
    gathered = ops.gather(local).cpu().numpy()
    assert gathered.shape[0] == 4 * state.num_processes
    np.testing.assert_allclose(gathered, np.concatenate([np.arange(4) + 10 * i for i in range(state.num_processes)]))
    state.wait_for_everyone()
    print("gather ✓")


def gather_object_check(state):
    from accelerate_tpu_torch.utils import operations as ops

    result = ops.gather_object([f"rank-{state.process_index}"])
    assert result == [f"rank-{i}" for i in range(state.num_processes)], result
    print("gather_object ✓")


def broadcast_check(state):
    from accelerate_tpu_torch.utils import operations as ops

    value = torch.full((3,), float(state.process_index), dtype=torch.float32, device=state.device)
    out = ops.broadcast(value, from_process=0).cpu().numpy()
    np.testing.assert_allclose(out, np.zeros(3, dtype=np.float32))

    objs = [state.process_index, {"rank": state.process_index}]
    objs = ops.broadcast_object_list(objs, from_process=0)
    assert objs[0] == 0 and objs[1] == {"rank": 0}
    print("broadcast ✓")


def reduce_check(state):
    from accelerate_tpu_torch.utils import operations as ops

    one = torch.ones((2,), dtype=torch.float32, device=state.device)
    summed = ops.reduce(one, reduction="sum").cpu().numpy()
    np.testing.assert_allclose(summed, np.full(2, float(state.num_processes)))
    mean = ops.reduce(one, reduction="mean").cpu().numpy()
    np.testing.assert_allclose(mean, np.ones(2))
    print("reduce ✓")


def pad_check(state):
    from accelerate_tpu_torch.utils import operations as ops

    local = torch.ones((2 + state.process_index, 3), dtype=torch.float32, device=state.device)
    padded = ops.pad_across_processes(local, dim=0)
    expected_rows = 2 + state.num_processes - 1
    assert padded.shape[0] == expected_rows, (padded.shape, expected_rows)
    assert float(padded.sum()) == float(local.sum()), "padding must add zeros only"
    print("pad_across_processes ✓")


def debug_mode_check(state):
    from accelerate_tpu_torch.utils import operations as ops
    from accelerate_tpu_torch.utils.operations import DistributedOperationException

    if state.num_processes == 1:
        print("debug_mode: skipped (single process)")
        return
    state.debug = True
    try:
        # Shapes that part across processes: caught before the collective hangs.
        bad = torch.ones((2 + state.process_index,), dtype=torch.float32, device=state.device)
        try:
            ops.gather(bad)
        except DistributedOperationException:
            print("debug_mode ✓")
        else:
            raise AssertionError("debug mode failed to flag mismatched shapes")
    finally:
        state.debug = False


def main():
    from accelerate_tpu_torch.state import PartialState

    state = PartialState()
    gather_check(state)
    gather_object_check(state)
    broadcast_check(state)
    reduce_check(state)
    pad_check(state)
    debug_mode_check(state)
    print("All op checks passed.")


if __name__ == "__main__":
    main()
