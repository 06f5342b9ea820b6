"""The port's disk tier: the native store (`accelerate_tpu_torch.native`,
its own copy of the JAX package's C++ data plane, built with g++ into
``build/``) and the folder of per-tensor files (`utils/offload.py`), held
to the JAX package's `native/offload.py` and `utils/offload.py` (about 10 s).

Round trips are exact: every dtype, bf16 included, empty tensors, blocking
reads, readahead tickets (one and a group) into tensors the caller gives,
a store reopened from its index and reset. Each package reads a
store and a folder the other wrote. A failed build raises (JAX falls back
to numpy; the port has no fallback), and so does a read past the blob's
end.
"""

import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from accelerate_tpu.native import NativeOffloadStore as JaxStore
from accelerate_tpu.utils import offload as joff
from accelerate_tpu_torch import native
from accelerate_tpu_torch.native import NativeOffloadStore
from accelerate_tpu_torch.utils import offload as poff


@pytest.fixture(autouse=True)
def two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _tensors():
    gen = torch.Generator().manual_seed(0)
    return {
        "layer_0/kernel": torch.randn(64, 32, generator=gen),
        "layer_0/bias": torch.arange(32, dtype=torch.float32),
        "layer_1/kernel": torch.randn(32, 16, generator=gen).to(torch.bfloat16),
        "layer_1/ids": torch.arange(10, dtype=torch.int64),
        "layer_1/flags": torch.tensor([True, False, True]),
        "big": torch.randn(3 << 20, generator=gen),  # past the inline read and the stripe floor
        "empty": torch.zeros(0, 4),
    }


def test_store_round_trips_every_read_path(tmp_path):
    tensors = _tensors()
    store = NativeOffloadStore(str(tmp_path), num_threads=3)
    store.save(tensors)
    assert store.bytes_written == sum(t.numel() * t.element_size() for t in tensors.values())
    again = NativeOffloadStore(str(tmp_path), num_threads=2)  # reopened from the index
    assert set(again.keys()) == set(tensors)
    for name, want in tensors.items():
        got = again.read(name)
        assert got.dtype == want.dtype and torch.equal(got, want)
    outs = [torch.empty_like(t) for t in tensors.values()]
    again.prefetch_many(list(tensors), outs)
    for (name, want), out in zip(tensors.items(), outs):
        got = again.read(name, out=out)
        assert got.data_ptr() == out.data_ptr() and torch.equal(got, want)
    again.prefetch("big")
    assert torch.equal(again.read("big"), tensors["big"])
    with pytest.raises(ValueError, match="contiguous host tensor"):
        again.read("big", out=torch.empty(5))
    size = (tmp_path / "weights.bin").stat().st_size
    again.save({"extra": torch.zeros(40)})  # appended
    assert (tmp_path / "weights.bin").stat().st_size == size + 160 and again.read("extra").shape == (40,)
    again.reset()
    assert not list(again.keys()) and not (tmp_path / "weights.bin").exists()
    for s in (store, again):
        s.close()


def test_stores_read_each_others_blobs(tmp_path):
    """The blob and index layouts are JAX's: dtype names, offsets, shapes."""
    tensors = {k: v for k, v in _tensors().items() if k not in ("layer_1/flags",)}
    port = NativeOffloadStore(str(tmp_path / "port"))
    port.save(tensors)
    jax_side = JaxStore(str(tmp_path / "port"))
    for name, want in tensors.items():
        got = np.asarray(jax_side.read(name))
        np.testing.assert_array_equal(got.astype(np.float32) if want.dtype == torch.bfloat16 else got,
                                      want.float().numpy() if want.dtype == torch.bfloat16 else want.numpy())
    arrays = {"w": np.arange(12, dtype=np.float32).reshape(3, 4), "b": np.asarray(jnp.ones(5, jnp.bfloat16) * 1.5)}
    JaxStore(str(tmp_path / "jax")).save(arrays)
    back = NativeOffloadStore(str(tmp_path / "jax"))
    assert torch.equal(back.read("w"), torch.arange(12, dtype=torch.float32).reshape(3, 4))
    assert torch.equal(back.read("b"), torch.full((5,), 1.5, dtype=torch.bfloat16))
    for s in (port, jax_side, back):
        s.close()


def test_a_read_past_the_end_raises(tmp_path):
    store = NativeOffloadStore(str(tmp_path))
    store.save({"w": torch.arange(1 << 22, dtype=torch.float32), "v": torch.arange(8, dtype=torch.float32)})
    store.index["w"]["offset"] = 10**9
    store.index["v"]["offset"] = 10**9
    store.prefetch("w")
    with pytest.raises(IOError):
        store.read("w")
    with pytest.raises(IOError, match="short read"):
        store.read("v")
    store.close()


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source that does not compile, and a missing compiler, raise: there
    is no numpy fallback."""
    broken = tmp_path / "data_plane.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="building data_plane.cpp failed"):
        native.load_library()
    with pytest.raises(RuntimeError, match="building"):
        NativeOffloadStore(str(tmp_path / "store"))
    monkeypatch.setenv("CXX", "no-such-compiler-here")
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        native.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_builds_once_into_build_and_binds():
    lib = native.load_library()
    assert native.library_path().exists() and native.library_path().parent.name == "accelerate_tpu_torch"
    assert native.load_library() is lib
    pool = lib.atl_pool_create(2)
    assert lib.atl_pool_size(pool) == 2
    lib.atl_pool_destroy(ctypes.c_void_p(pool))


def test_offload_folder_round_trips_and_is_jax_readable(tmp_path):
    """`offload_weight` writes JAX's file and index layout (bf16 as its
    uint16 bits): each package reads the other's folder exactly."""
    tensors = {k: v for k, v in _tensors().items() if k in ("layer_0/kernel", "layer_0/bias", "layer_1/kernel")}
    index = None
    for name, t in tensors.items():
        index = poff.offload_weight(t, name, str(tmp_path / "port"), index)
    poff.save_offload_index(index, str(tmp_path / "port"))
    assert poff.load_offload_index(str(tmp_path / "port")) == joff.load_offload_index(str(tmp_path / "port")) == index
    port_loader = poff.OffloadedWeightsLoader(save_folder=str(tmp_path / "port"))
    jax_loader = joff.OffloadedWeightsLoader(save_folder=str(tmp_path / "port"))
    for name, want in tensors.items():
        assert torch.equal(port_loader[name], want)
        np.testing.assert_array_equal(np.asarray(jax_loader[name], dtype=np.float32), want.float().numpy())
    jindex = None
    for name, t in tensors.items():
        jindex = joff.offload_weight(jnp.asarray(t.float().numpy()).astype(
            jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32), name, str(tmp_path / "jax"), jindex)
    joff.save_offload_index(jindex, str(tmp_path / "jax"))
    from_jax = poff.OffloadedWeightsLoader(save_folder=str(tmp_path / "jax"))
    assert list(from_jax) == list(tensors) and len(from_jax) == len(tensors)
    for name, want in tensors.items():
        assert torch.equal(from_jax[name], want)
    assert poff.load_offload_index(str(tmp_path / "nowhere")) == {}


def test_loader_prefix_view_and_submodule_state(tmp_path):
    """The memory side of a loader wins; `PrefixedDataset` strips a prefix
    on lookup and iterates the full keys, as JAX's does; a block's state
    comes from a module by flax path."""
    from accelerate_tpu_torch.models import llama

    index = poff.offload_weight(torch.ones(2), "a/x", str(tmp_path))
    poff.save_offload_index(index, str(tmp_path))
    loader = poff.OffloadedWeightsLoader(state_dict={"a/x": torch.zeros(2), "b/y": torch.ones(3)},
                                         save_folder=str(tmp_path))
    jloader = joff.OffloadedWeightsLoader(state_dict={"a/x": np.zeros(2), "b/y": np.ones(3)}, save_folder=str(tmp_path))
    assert list(loader) == list(jloader) == ["a/x", "b/y"]
    assert torch.equal(loader["a/x"], torch.zeros(2))
    view, jview = poff.PrefixedDataset(loader, "b/"), joff.PrefixedDataset(jloader, "b/")
    assert list(view) == list(jview) == ["b/y"] and len(view) == len(jview) == 1
    assert torch.equal(view["y"], torch.ones(3))
    with pytest.raises(ValueError):
        poff.OffloadedWeightsLoader()
    model = llama.LlamaForCausalLM(llama.llama_tiny())
    state = poff.extract_submodule_state(model, "params/layer_1/mlp")
    assert sorted(state) == ["params/layer_1/mlp/w_down/kernel", "params/layer_1/mlp/w_gate/kernel",
                             "params/layer_1/mlp/w_up/kernel"]
    assert state["params/layer_1/mlp/w_up/kernel"] is model.layers[1].mlp.w_up.weight
