"""The port's hooks (`accelerate_tpu_torch.hooks`) held to
`accelerate_tpu/hooks.py` (about 5 s): each of JAX's scenarios from
`tests/test_hooks.py` run on both sides, a JAX bundle whose `apply_fn`
is hooked and a torch module whose `forward` is, with the same outputs
and the same order of hook calls; then what only a module has: weights
moved between the host and the execution device (`CpuOffload`, chained
through `prev_module_hook`) and filled from an offload folder for each
forward (`AlignDevicesHook`).
"""

import pytest
import torch
from torch import nn

import jax.numpy as jnp

from accelerate_tpu import hooks as jhooks
from accelerate_tpu.modeling import Model
from accelerate_tpu_torch import hooks
from accelerate_tpu_torch.utils.offload import OffloadedWeightsLoader, offload_weight, save_offload_index


@pytest.fixture(autouse=True)
def two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


class Scale(nn.Module):
    def __init__(self, w=2.0):
        super().__init__()
        self.w = nn.Parameter(torch.tensor([w]))

    def forward(self, x):
        return x * self.w


def _jax_model(w=2.0):
    return Model.from_fn(lambda p, x: x * p["w"], {"w": jnp.asarray([w])})


def _pair(w=2.0):
    return _jax_model(w), Scale(w)


def _run(jm, pm, x):
    """(JAX's output, the port's) as floats."""
    with torch.no_grad():
        return float(jm.apply_fn(jm.params, jnp.asarray([x]))[0]), float(pm(torch.tensor([x]))[0])


def _hook_pair(name, *args):
    """JAX's hook and the port's, one behaviour."""
    class JaxPlusOne(jhooks.ModelHook):
        def post_forward(self, model, output):
            return output + 1

    class PlusOne(hooks.ModelHook):
        def post_forward(self, module, output):
            return output + 1

    class JaxTimesTwoInput(jhooks.ModelHook):
        def pre_forward(self, model, params, args, kwargs):
            return params, tuple(a * 2 for a in args), kwargs

    class TimesTwoInput(hooks.ModelHook):
        def pre_forward(self, module, args, kwargs):
            return tuple(a * 2 for a in args), kwargs

    class JaxRecorder(jhooks.ModelHook):
        def __init__(self, log, tag):
            self.log, self.tag = log, tag

        def init_hook(self, model):
            self.log.append(f"init:{self.tag}")
            return model

        def pre_forward(self, model, params, args, kwargs):
            self.log.append(f"pre:{self.tag}")
            return params, args, kwargs

        def post_forward(self, model, output):
            self.log.append(f"post:{self.tag}")
            return output

        def detach_hook(self, model):
            self.log.append(f"detach:{self.tag}")
            return model

    class Recorder(hooks.ModelHook):
        def __init__(self, log, tag):
            self.log, self.tag = log, tag

        def init_hook(self, module):
            self.log.append(f"init:{self.tag}")
            return module

        def pre_forward(self, module, args, kwargs):
            self.log.append(f"pre:{self.tag}")
            return args, kwargs

        def post_forward(self, module, output):
            self.log.append(f"post:{self.tag}")
            return output

        def detach_hook(self, module):
            self.log.append(f"detach:{self.tag}")
            return module

    table = {"plus_one": (JaxPlusOne, PlusOne), "times_two_input": (JaxTimesTwoInput, TimesTwoInput),
             "recorder": (JaxRecorder, Recorder)}
    jcls, pcls = table[name]
    return jcls(*args), pcls(*args)


def test_add_and_remove_hook_equal_jax():
    jm, pm = _pair()
    jh, ph = _hook_pair("plus_one")
    assert _run(jm, pm, 3.0) == (6.0, 6.0)
    jhooks.add_hook_to_module(jm, jh)
    hooks.add_hook_to_module(pm, ph)
    assert _run(jm, pm, 3.0) == (7.0, 7.0)
    jhooks.remove_hook_from_module(jm)
    hooks.remove_hook_from_module(pm)
    assert _run(jm, pm, 3.0) == (6.0, 6.0)
    assert pm._atl_hook is None and "forward" not in vars(pm)


def test_pre_forward_rewrites_the_arguments_as_jax():
    jm, pm = _pair()
    jh, ph = _hook_pair("times_two_input")
    jhooks.add_hook_to_module(jm, jh)
    hooks.add_hook_to_module(pm, ph)
    assert _run(jm, pm, 3.0) == (12.0, 12.0)


def test_sequential_hook_order_equals_jax():
    jlog, plog = [], []
    jm, pm = _pair()
    jhooks.add_hook_to_module(jm, jhooks.SequentialHook(*(_hook_pair("recorder", jlog, t)[0] for t in "ab")))
    hooks.add_hook_to_module(pm, hooks.SequentialHook(*(_hook_pair("recorder", plog, t)[1] for t in "ab")))
    _run(jm, pm, 1.0)
    jhooks.remove_hook_from_module(jm)
    hooks.remove_hook_from_module(pm)
    assert plog == jlog == ["init:a", "init:b", "pre:a", "pre:b", "post:a", "post:b", "detach:a", "detach:b"]


def test_append_chains_and_stacking_equal_jax():
    """`append` runs both as one `SequentialHook`; without it a second hook
    wraps the hooked forward, and removing it peels one layer, in both."""
    for append in (True, False):
        jm, pm = _pair()
        for _ in range(2):
            jh, ph = _hook_pair("plus_one")
            jhooks.add_hook_to_module(jm, jh, append=append)
            hooks.add_hook_to_module(pm, ph, append=append)
        assert _run(jm, pm, 3.0) == (8.0, 8.0)
        assert isinstance(pm._atl_hook, hooks.SequentialHook) == append
        jhooks.remove_hook_from_module(jm)
        hooks.remove_hook_from_module(pm)
        assert _run(jm, pm, 3.0) == ((6.0, 6.0) if append else (7.0, 7.0))


def test_cpu_offload_round_trip_and_chaining():
    """JAX's round trip and chaining outputs; the port's weights live in
    host RAM between calls and are on the execution device during one,
    and running the second model sends the first's home."""
    jm, pm = _pair(2.0)
    jm, jhandle = jhooks.cpu_offload_with_hook(jm)
    pm, handle = hooks.cpu_offload_with_hook(pm, execution_device="cpu")
    assert pm.w.device.type == "cpu" and isinstance(handle.hook, hooks.CpuOffload)
    assert _run(jm, pm, 2.0) == (4.0, 4.0)
    handle.offload()
    handle.remove()
    jhandle.remove()
    assert pm._atl_hook is None and jm._atl_hook is None

    ja, pa = _pair(2.0)
    jb, pb = _pair(3.0)
    ja, jha = jhooks.cpu_offload_with_hook(ja)
    jb, _ = jhooks.cpu_offload_with_hook(jb, prev_module_hook=jha)
    pa, pha = hooks.cpu_offload_with_hook(pa, execution_device="cpu")
    offloaded = []
    pha.offload = (lambda f: lambda: (offloaded.append("a"), f())[1])(pha.offload)
    pb, _ = hooks.cpu_offload_with_hook(pb, execution_device="cpu", prev_module_hook=pha)
    assert _run(ja, pa, 1.0) == (2.0, 2.0) and offloaded == []
    assert _run(jb, pb, 1.0) == (3.0, 3.0) and offloaded == ["a"]


def test_cpu_offload_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hooks.cpu_offload_with_hook(Scale())


def test_align_devices_hook_fills_the_module_from_an_offload_folder(tmp_path):
    """The weights come from the folder for the forward and leave after it
    (meta tensors between calls); without `offload` they stay."""
    torch.manual_seed(0)
    layer = nn.Linear(8, 4)
    x = torch.randn(3, 8)
    want = layer(x)
    index = None
    for name, t in layer.state_dict().items():
        index = offload_weight(t, name, str(tmp_path), index)
    save_offload_index(index, str(tmp_path))
    weights = OffloadedWeightsLoader(save_folder=str(tmp_path))
    empty = nn.Linear(8, 4, device="meta")
    hooks.add_hook_to_module(empty, hooks.AlignDevicesHook("cpu", weights_map=weights, io_same_device=True))
    assert empty.weight.is_meta
    assert torch.equal(empty(x), want)
    assert empty.weight.is_meta and empty.bias.is_meta
    kept = nn.Linear(8, 4, device="meta")
    hooks.add_hook_to_module(kept, hooks.AlignDevicesHook("cpu", weights_map=weights, offload=False))
    assert torch.equal(kept(x), want) and not kept.weight.is_meta
    plain = nn.Linear(8, 4)
    plain.load_state_dict(layer.state_dict())
    hooks.add_hook_to_module(plain, hooks.AlignDevicesHook("cpu"))
    assert torch.equal(plain(x), want)
