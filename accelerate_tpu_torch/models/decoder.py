"""What the port's causal decoders share: the attention modes, flax's
LayerNorm and Dense, the decoder's forward, random weights built in place
and the carry of a flax params tree.

`CausalDecoder` is the forward every causal family shares (Llama, GPT-NeoX,
GPT-J, OPT, Mixtral): embed, the layer loop through `ops.remat.maybe_remat`, the
final norm and the head, in the four modes of `ops.attention.attend` (the
training forward, the cached prefill, the engine's slot pools, the
`Generator`'s decode cache); each family supplies its embedding, blocks and
head. `DecoderAttention` is the multi-head attention of GPT-NeoX, GPT-J and
OPT (Llama's has grouped-query heads of its own). `causal_lm_loss` is the
loss every one of them bundles.

The dtype flow is flax's defaults, as the JAX families run them:
`LayerNorm` takes its statistics and normalises in f32 and returns the
promoted type of its input and parameters (bf16 under a bf16
`PreparedModel`, whose parameters arrive as bf16 copies); `Dense` promotes
its input and weight to one type before the product.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, make_generator, resolve_device
from ..ops.attention import DecodeCache, attend, decode_cache_mask
from ..ops.losses import global_mean
from ..ops.remat import maybe_remat


def causal_lm_loss(batch, apply_fn):
    """Next-token cross-entropy with shift; positions whose label is < 0 are
    ignored. `apply_fn(input_ids, attention_mask)` gives the logits (the
    prepared model's forward under its precision policy); labels default to
    the inputs. The port of JAX's `causal_lm_loss(params, batch, apply_fn)`,
    with the parameters implicit in the module."""
    logits = apply_fn(batch["input_ids"], batch.get("attention_mask"))
    labels = batch.get("labels", batch["input_ids"])
    shift_logits = logits[:, :-1].float()
    shift_labels = labels[:, 1:].long()
    logp = torch.log_softmax(shift_logits, dim=-1)
    valid = (shift_labels >= 0).float()
    safe_labels = shift_labels.clamp_min(0)
    nll = -torch.gather(logp, -1, safe_labels[..., None])[..., 0]
    return global_mean(nll, valid)


class Dense(nn.Linear):
    """flax's ``nn.Dense(dtype=None)``: input, weight and bias promoted to
    one dtype before the product."""

    def forward(self, x):
        dtype = torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dtype)
        return F.linear(x.to(dtype), self.weight.to(dtype), bias)


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm(dtype=None)``: statistics, scale and bias in
    f32, the output in the promoted type of x, scale and bias. (flax takes
    the variance as E[x^2] - E[x]^2, torch's `layer_norm` as the mean square
    deviation; the families' f32 logits agree with JAX's within 1e-4
    either way, `tests/test_torch_families.py`.)"""

    def __init__(self, hidden: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(hidden))
        self.bias = nn.Parameter(torch.zeros(hidden))

    def forward(self, x):
        dtype = torch.promote_types(torch.promote_types(x.dtype, self.weight.dtype), self.bias.dtype)
        y = F.layer_norm(x.float(), self.weight.shape, self.weight.float(), self.bias.float(), self.eps)
        return y.to(dtype)


class DecoderAttention(nn.Module):
    """Multi-head attention with `wq`, `wk`, `wv`, `wo` (biased or not) and
    a rotary embedding applied to q and k (`rotary(x, positions)`, or None
    for a family with learned positions), through `attend`."""

    def __init__(self, hidden: int, heads: int, bias: bool, rotary=None):
        super().__init__()
        self.heads, self.head_dim, self.rotary = heads, hidden // heads, rotary
        self.wq, self.wk, self.wv, self.wo = (Dense(hidden, hidden, bias=bias) for _ in range(4))

    def forward(self, hidden, positions, *modes):
        b, s, _ = hidden.shape
        q, k, v = (w(hidden).reshape(b, s, self.heads, self.head_dim) for w in (self.wq, self.wk, self.wv))
        if self.rotary is not None:
            q, k = self.rotary(q, positions), self.rotary(k, positions)
        return self.wo(attend(q, k, v, positions, *modes).reshape(b, s, -1))


class CausalDecoder(nn.Module):
    """A decoder-only causal LM: ``embed(input_ids, positions)``, the blocks
    in `self.layers` (each called as ``block(hidden, positions,
    attention_mask, kv_pool, page_table, attention_impl, kv_cache,
    decode_cache)``), `self.final_norm` and ``head(hidden)``.

    The engine, `generate` and the training step drive every family alike
    through `forward`. A family
    whose JAX module has no slot cache sets `slot_serving` False, and the
    engine refuses it, as JAX's does."""

    loss_fn = staticmethod(causal_lm_loss)
    slot_serving = True

    def get_input_embeddings(self) -> nn.Embedding:
        raise NotImplementedError

    def embed(self, input_ids, positions):
        return self.get_input_embeddings()(input_ids)

    def head(self, hidden):
        raise NotImplementedError

    def forward(self, input_ids, attention_mask=None, positions=None, kv_pools=None, page_table=None,
                attention_impl: str = "gather", kv_cache=None, decode_cache: Optional[DecodeCache] = None,
                return_aux: bool = False):
        """[B, S] token ids -> [B, S, vocab] logits; the first three arguments
        in JAX's order (`LlamaForCausalLM.__call__`).

        Without caches this is the full causal forward; `attention_mask`
        ([B, S], True or 1 = a real token) keeps pad keys out of every row,
        as in JAX. With `kv_pools` (one (k_pool, v_pool) pair per layer,
        [num_pages, page_size, Hkv, D] each, followed by its k_scale and
        v_scale for an int8/fp8 pool) the tokens' K/V are written into the
        pools at `positions` through `page_table` ([B, pages_per_slot] int32)
        and attended there. With `kv_pools` and no `page_table` the pairs
        are the contiguous layout's per-slot rows, [B, L, Hkv, D]. With
        `kv_cache` (one dense (k_cache, v_cache) pair per layer, [B, L, Hkv,
        D]) they are written into those caches at `positions` and attended
        there: the cached prefill.

        With `decode_cache` (`make_decode_cache`) the block is written at
        the cache's shared index, which then advances by S; `positions` are
        the rotary (or learned-position) positions only, and
        `attention_mask` ([B, S]) is stored as the cache's persistent pad
        mask (JAX's decode-cache mode).

        A block may return ``(hidden, aux)``, a dict of scalar losses
        (Mixtral's router losses); with `return_aux` the forward returns
        ``(logits, aux)``, each entry summed over the layers and divided by
        their number, as JAX's `MixtralForCausalLM` does."""
        b, s = input_ids.shape
        if positions is None:
            positions = torch.arange(s, device=input_ids.device)[None, :].expand(b, s)
        if decode_cache is not None:
            attention_mask = decode_cache_mask(decode_cache, s, attention_mask)
        hidden = self.embed(input_ids, positions)
        total_aux = None
        for i, layer in enumerate(self.layers):
            pool = None if kv_pools is None else kv_pools[i]
            cache = None if kv_cache is None else kv_cache[i]
            dcache = None if decode_cache is None else (decode_cache, i)
            out = maybe_remat(layer, hidden, positions, attention_mask, pool, page_table, attention_impl, cache,
                              dcache)
            if isinstance(out, tuple):
                hidden, aux = out
                total_aux = aux if total_aux is None else {k: total_aux[k] + aux[k] for k in total_aux}
            else:
                hidden = out
        if decode_cache is not None:
            decode_cache.index += s
        logits = self.head(self.final_norm(hidden))
        if not return_aux:
            return logits
        if total_aux is None:
            raise ValueError(f"{type(self).__name__}'s blocks return no auxiliary losses")
        return logits, {k: v / max(len(self.layers), 1) for k, v in total_aux.items()}

    def make_decode_cache(self, batch: int, max_length: int, dtype: Optional[torch.dtype] = None,
                          device=None) -> DecodeCache:
        """A zeroed decode cache for `batch` rows of `max_length` positions,
        in `dtype` (the weights' by default) on `device` (the weights')."""
        cfg, weight = self.config, self.get_input_embeddings().weight
        return DecodeCache.create(
            cfg.num_hidden_layers, batch, max_length, cfg.num_key_value_heads, cfg.head_dim,
            dtype or weight.dtype, device or weight.device,
        )


@torch.no_grad()
def random_init(build, seed: int, dtype: torch.dtype, device: DeviceLike, embed_std=None) -> nn.Module:
    """``build()`` (a module constructor) with random weights from `seed`,
    made in `dtype` directly on the device: the module is built without
    storage, given storage in `dtype`, and filled module by module from one
    generator on that device, so no f32 copy of a model too large for it
    in f32 is ever made. Linear weights are normal with std 1/sqrt(fan_in),
    biases normal with std 0.02, embeddings normal with `embed_std` (1 by
    default; a function of the embedding module gives each its own),
    LayerNorm scales ones and biases zeros, RMSNorm scales ones, the
    experts' [E, in, out] weights normal with std 1/sqrt(in)."""
    from ..parallel.expert import ExpertMLP
    from .llama import RMSNorm

    dev = resolve_device(device)
    with torch.device("meta"):
        model = build()
    model = model.to(dtype).to_empty(device=dev)
    gen = make_generator(seed, dev)
    for module in model.modules():
        if isinstance(module, nn.Linear):
            module.weight.normal_(0.0, module.in_features ** -0.5, generator=gen)
            if module.bias is not None:
                module.bias.normal_(0.0, 0.02, generator=gen)
        elif isinstance(module, nn.Embedding):
            std = embed_std(module) if callable(embed_std) else (1.0 if embed_std is None else embed_std)
            module.weight.normal_(0.0, std, generator=gen)
        elif isinstance(module, LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, RMSNorm):
            module.weight.fill_(1.0)
        elif isinstance(module, ExpertMLP):
            module.normal_(gen)
    return model.eval()


#: flax leaf name -> torch parameter name
_LEAVES = {"kernel": "weight", "bias": "bias", "scale": "weight", "embedding": "weight", "rel_embedding": "weight"}


def state_dict_from_flax(params, num_layers: int) -> Dict[str, torch.Tensor]:
    """The `state_dict` of a family whose modules carry the flax tree's
    names, from its params tree given as numpy arrays: ``layer_{i}/...``
    becomes ``layers.{i}....``, `Dense` kernels ([in, out]) are transposed
    to `nn.Linear` weights ([out, in]), LayerNorm scales and embeddings
    become ``weight``. A scanned tree (``scan_layers=True``: one stacked
    ``blocks/block`` subtree) is unstacked along its leading axis first.
    A name that occurs at the top and inside a block (OPT's ``final_norm``)
    keeps both places apart by its path."""
    tree = params["params"] if "params" in params else params
    tree = dict(tree)
    if "blocks" in tree:
        stacked = tree.pop("blocks")["block"]

        def take(node, i):
            return {k: take(v, i) for k, v in node.items()} if isinstance(node, dict) else np.asarray(node)[i]

        for i in range(num_layers):
            tree[f"layer_{i}"] = take(stacked, i)
    n_tree = sum(k.startswith("layer_") for k in tree)
    if n_tree != num_layers:
        raise ValueError(f"params tree has {n_tree} layers, the config {num_layers}")
    return flax_tree_to_state_dict(tree)


def flax_tree_to_state_dict(tree) -> Dict[str, torch.Tensor]:
    """The walk of `state_dict_from_flax` over a per-layer tree: a list
    entry ``<name>_{i}`` (``layer_{i}``, T5's ``enc_blocks_{i}``) becomes
    ``<name>.{i}`` (``layer`` as ``layers``), `Dense` kernels are
    transposed, and each leaf takes its torch name (`_LEAVES`). A leaf
    named ``<name>/kernel`` is a bare parameter of that name, kept as it is
    (the experts' [E, in, out] weights, ``experts/w_gate/kernel``)."""
    sd = {}

    def walk(node, path):
        for key, value in node.items():
            if isinstance(value, dict):
                m = re.fullmatch(r"(layer|enc_blocks|dec_blocks)_(\d+)", key)
                name = f"{'layers' if m.group(1) == 'layer' else m.group(1)}.{m.group(2)}" if m else key
                walk(value, path + [name])
                continue
            name, slash, leaf = key.partition("/")
            if slash and leaf == "kernel":
                sd[".".join(path + [name])] = torch.from_numpy(np.array(value))
                continue
            if key not in _LEAVES:
                raise ValueError(f"unexpected leaf {'/'.join(path + [key])}")
            t = torch.from_numpy(np.array(value))
            sd[".".join(path + [_LEAVES[key]])] = t.T.contiguous() if key == "kernel" else t

    walk(tree, [])
    return sd
