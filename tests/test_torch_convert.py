"""`accelerate-tpu-torch convert`, the native pytree file and
`utils/versions.py`, held to the JAX package. About 30 s: most of it the
two CLI subprocesses (JAX's `tests/test_convert_cli.py` runs the CLI the
same way) and JAX's tiny models.

  - `save_pytree` / `load_pytree`: a file written by either package loads
    in the other with the same paths, dtypes (bf16 included) and leaves,
    bit for bit; a truncated payload raises `CheckpointCorruptError`; a
    manifest whose treedef names any other global than jax's `PyTreeDef`
    and `default_registry` raises and runs nothing. The port reads the
    treedef with an unpickler that resolves those two names only; the
    names and kind codes are jax 0.9.0's, pinned here against jax itself.
  - `convert`: JAX's GPT-J round trip through the port's CLI as a
    subprocess (JAX's `apply_fn` on the converted tree equals its own
    logits within 1e-6, and `to_hf` writes HF names), a Llama round trip in
    process through the dispatcher's `main`, the family mismatch refused
    with JAX's message, the `--model_type` choices equal to the interchange
    registry, and `merge` refused naming ROADMAP A's order step 6.
  - `compare_versions` equal to JAX's; `is_torch_version` reads torch's.
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.checkpointing import load_pytree as jax_load_pytree
from accelerate_tpu.checkpointing import save_pytree as jax_save_pytree
from accelerate_tpu.parallel.sharding import tree_paths_and_leaves as jax_tree_paths_and_leaves
from accelerate_tpu.utils.versions import compare_versions as jax_compare_versions
from accelerate_tpu_torch import checkpointing
from accelerate_tpu_torch.checkpointing import CheckpointCorruptError, load_pytree, save_pytree
from accelerate_tpu_torch.utils.versions import compare_versions, is_torch_version

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree(rng):
    """A nested tree of dicts, a list, a tuple, a None and a bf16 leaf, as
    numpy (for JAX) and as torch (for the port)."""
    bf16 = rng.normal(size=(3, 5)).astype(np.float32)
    np_tree = {
        "params": {"dense": {"kernel": rng.normal(size=(4, 3)).astype(np.float32),
                             "bias": np.arange(3, dtype=np.int32)},
                   "blocks": [rng.normal(size=(2,)).astype(np.float64), {"scale": np.float32(1.5)}],
                   "bf16": jnp.asarray(bf16, jnp.bfloat16), "none": None, "pair": (np.int64(7),)},
        "step": np.asarray(3, np.int32),
    }
    torch_tree = {
        "params": {"dense": {"kernel": torch.from_numpy(np_tree["params"]["dense"]["kernel"]),
                             "bias": torch.arange(3, dtype=torch.int32)},
                   "blocks": [torch.from_numpy(np_tree["params"]["blocks"][0]), {"scale": torch.tensor(1.5)}],
                   "bf16": torch.from_numpy(bf16).to(torch.bfloat16), "none": None, "pair": (torch.tensor(7),)},
        "step": torch.tensor(3, dtype=torch.int32),
    }
    return np_tree, torch_tree


def _bits(x):
    """A leaf's dtype name and raw bits, from either package."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return "bfloat16", x.view(torch.int16).numpy().tobytes(), tuple(x.shape)
        x = x.numpy()
    x = np.asarray(x)
    return x.dtype.name, x.tobytes(), x.shape


def _flat(tree):
    leaves, treedef = jax.tree_util.tree_flatten(tree, is_leaf=lambda x: isinstance(x, torch.Tensor))
    return [_bits(x) for x in leaves], treedef


def test_a_port_file_loads_in_jax_and_a_jax_file_in_the_port(tmp_path):
    np_tree, torch_tree = _tree(np.random.default_rng(0))
    save_pytree(torch_tree, str(tmp_path / "port"))
    jax_save_pytree(np_tree, str(tmp_path / "jax"))
    for ours, theirs in ((jax_load_pytree(str(tmp_path / "port")), np_tree),
                         (load_pytree(str(tmp_path / "jax")), np_tree),
                         (load_pytree(str(tmp_path / "port")), np_tree)):
        (a, ta), (b, tb) = _flat(ours), _flat(theirs)
        assert ta == tb
        assert [(n, s) for n, _, s in a] == [(n, s) for n, _, s in b]
        assert a == b
    manifests = [json.load(open(tmp_path / f"{n}.manifest.json")) for n in ("port", "jax")]
    for key in ("paths", "dtypes"):
        assert manifests[0][key] == manifests[1][key]
    assert pickle.loads(bytes.fromhex(manifests[0]["treedef"])) == _flat(np_tree)[1]  # jax reads the port's


def test_truncated_payload_raises(tmp_path):
    _, torch_tree = _tree(np.random.default_rng(1))
    path = str(tmp_path / "ckpt")
    save_pytree(torch_tree, path)
    with open(path + ".npz", "r+b") as f:
        f.truncate(os.path.getsize(path + ".npz") // 2)
    with pytest.raises(CheckpointCorruptError, match="SHA-256 mismatch"):
        load_pytree(path)


def test_a_treedef_naming_another_global_raises_and_runs_nothing(tmp_path):
    """A manifest whose treedef would call `os.system` (what `pickle.loads`
    of a crafted file runs) is refused by name; nothing runs. So is a
    stream whose class is right but whose state names another global."""
    _, torch_tree = _tree(np.random.default_rng(2))
    path = str(tmp_path / "ckpt")
    save_pytree(torch_tree, path)
    marker = tmp_path / "ran"

    class Evil:
        def __reduce__(self):
            return os.system, (f"touch {marker}",)

    manifest = json.load(open(path + ".manifest.json"))
    for payload in (pickle.dumps(Evil()), pickle.dumps(Evil(), protocol=2),
                    checkpointing._treedef_pickle([(0, 0, None, None, 1, 1)]).replace(
                        b"jax._src.tree_util\ndefault_registry", b"builtins\neval")):
        manifest["treedef"] = payload.hex()
        with open(path + ".manifest.json", "w") as f:
            json.dump(manifest, f)
        with pytest.raises(CheckpointCorruptError, match="names the global"):
            load_pytree(path)
        assert not marker.exists()


def test_the_treedef_stream_is_jaxs():
    """The names and kind codes the port writes and reads are jax's: a
    PyTreeDef jax pickles holds exactly the port's node tuples."""
    np_tree, torch_tree = _tree(np.random.default_rng(3))
    paths, leaves, nodes = [], [], []
    checkpointing._tree_nodes(torch_tree, "", paths, leaves, nodes)
    treedef = _flat(np_tree)[1]
    assert pickle.loads(checkpointing._treedef_pickle(nodes)) == treedef
    assert checkpointing._treedef_nodes(pickle.dumps(treedef).hex()) == nodes
    assert paths == [p for p, _ in jax_tree_paths_and_leaves(np_tree)[0]]


def _cli(*args):
    result = subprocess.run([sys.executable, "-m", "accelerate_tpu_torch.commands.accelerate_cli", *args],
                            cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
                            timeout=300)
    return result


def test_convert_round_trip_gptj_through_the_cli(tmp_path):
    """JAX's `test_convert_round_trip_gptj` with the port's CLI doing the
    conversion: JAX's `load_pytree` and `apply_fn` on the port's file."""
    from accelerate_tpu.models.gptj import create_gptj_model, gptj_tiny
    from accelerate_tpu.utils.hf_loading import load_hf_state_dict, save_hf_checkpoint

    cfg = gptj_tiny()
    model = create_gptj_model(cfg, seq_len=16)
    hf_path = str(tmp_path / "hf.safetensors")
    save_hf_checkpoint(model.params, "gptj", cfg, hf_path)
    native = str(tmp_path / "native")
    result = _cli("convert", hf_path, native, "--model_type", "gptj", "--model", "gptj-tiny")
    assert result.returncode == 0, result.stdout + result.stderr
    assert "from_hf" in result.stdout
    params = jax_load_pytree(native)
    ids = jnp.asarray(np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 8)), jnp.int32)
    np.testing.assert_allclose(np.asarray(model.apply_fn(params, ids)), np.asarray(model.apply_fn(model.params, ids)),
                               rtol=1e-6, atol=1e-6)
    hf2 = str(tmp_path / "hf2.safetensors")
    result = _cli("convert", native, hf2, "--model_type", "gptj", "--model", "gptj-tiny", "--direction", "to_hf")
    assert result.returncode == 0, result.stdout + result.stderr
    flat, ref = load_hf_state_dict(hf2), load_hf_state_dict(hf_path)
    assert "transformer.h.0.attn.q_proj.weight" in flat
    assert sorted(flat) == sorted(ref) and all(np.array_equal(flat[k], ref[k]) for k in ref)


def test_convert_llama_in_process_both_ways(tmp_path, capsys):
    """A port Llama exported as HF, converted by the dispatcher's `main`:
    JAX's tree equals JAX's own conversion of the same file bit for bit
    (bf16 kept), and JAX's logits on it equal the port's; the way back
    writes the same safetensors."""
    from accelerate_tpu.utils.hf_loading import convert_hf_state_dict as jax_convert
    from accelerate_tpu.utils.hf_loading import load_hf_state_dict as jax_load_hf
    from accelerate_tpu.models import get_model_family as jax_family
    from accelerate_tpu.models.llama import create_llama_model as jax_llama
    from accelerate_tpu_torch.commands.accelerate_cli import main
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.utils.hf_loading import save_hf_checkpoint
    from accelerate_tpu_torch.utils.modeling import load_safetensors_state_dict

    model = llama.create_llama_model(llama.llama_tiny(), seed=3, dtype=torch.bfloat16, device="cpu")
    hf, native, back = (str(tmp_path / n) for n in ("hf.safetensors", "native.npz", "back.safetensors"))
    save_hf_checkpoint(model, "llama", model.config, hf)
    main(["convert", hf, native, "--model_type", "llama", "--model", "llama-tiny"])
    assert "from_hf, llama" in capsys.readouterr().out
    ours = jax_load_pytree(native)
    theirs = jax_convert(jax_load_hf(hf), "llama", jax_family("llama-tiny")[1])
    (a, ta), (b, tb) = _flat(ours), _flat(theirs)
    assert ta == tb and a == b
    jmodel = jax_llama(jax_family("llama-tiny")[1], seq_len=8)
    ids = np.random.default_rng(4).integers(0, 512, (2, 8))
    f32 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32), ours)
    want = model.float()(torch.as_tensor(ids)).detach().numpy()
    np.testing.assert_allclose(np.asarray(jmodel.apply_fn(f32, jnp.asarray(ids, jnp.int32))), want, rtol=1e-4, atol=1e-4)
    main(["convert", native, back, "--model_type", "llama", "--model", "llama-tiny", "--direction", "to_hf"])
    x, y = load_safetensors_state_dict(hf), load_safetensors_state_dict(back)
    assert sorted(x) == sorted(y) and all(torch.equal(x[k], y[k]) for k in x)


def test_convert_rejects_family_mismatch():
    result = _cli("convert", "x", "y", "--model_type", "llama", "--model", "gptj-tiny")
    assert result.returncode != 0
    assert "is a 'gptj' config" in result.stderr


def test_cli_model_type_choices_match_interchange_registry():
    """JAX's pin, on the port: the static choices equal the interchange
    keys, the port's and JAX's."""
    import argparse

    from accelerate_tpu.utils.hf_loading import _FROM_HF as JAX_FROM_HF
    from accelerate_tpu_torch.commands.convert import register_subcommand
    from accelerate_tpu_torch.utils.hf_loading import _FROM_HF, _TO_HF

    parser = argparse.ArgumentParser()
    sub = register_subcommand(parser.add_subparsers())
    choices = next(a for a in sub._actions if a.dest == "model_type").choices
    assert set(choices) == set(_FROM_HF) == set(_TO_HF) == set(JAX_FROM_HF)


def test_registry_families_are_jaxs():
    from accelerate_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
    from accelerate_tpu_torch.models import MODEL_REGISTRY, get_model_family

    for name in MODEL_REGISTRY:
        assert get_model_family(name)[0] == JAX_REGISTRY[name][0], name
    with pytest.raises(ValueError, match="Unknown in-tree model"):
        get_model_family("no-such-model")


def test_merge_waits_for_order_step_6(tmp_path):
    from accelerate_tpu_torch.commands.accelerate_cli import main

    with pytest.raises(NotImplementedError, match="order step 6"):
        main(["merge", str(tmp_path), str(tmp_path / "out")])


@pytest.mark.parametrize("operation", ["<", "<=", "==", "!=", ">=", ">"])
@pytest.mark.parametrize("version", ["0.1", "1.0.0", "2.4.1", "99"])
def test_compare_versions_is_jaxs(operation, version):
    for library in ("numpy", "packaging"):
        assert compare_versions(library, operation, version) == jax_compare_versions(library, operation, version)
    with pytest.raises(ValueError):
        compare_versions("numpy", "~=", version)


def test_is_torch_version_reads_torch():
    from packaging.version import parse

    assert is_torch_version(">=", "2.0")
    assert is_torch_version("==", str(parse(torch.__version__)))
    assert not is_torch_version("<", "1.0")
