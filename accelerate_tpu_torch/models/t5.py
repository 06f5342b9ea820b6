"""T5 encoder-decoder in PyTorch: the port of `accelerate_tpu/models/t5.py`
(the reference's T0pp-11B config, the only encoder-decoder of the JAX
package).

T5 v1.1 (T0pp's base): RMSNorm without bias before each sublayer, a learned
relative-position bias on the first block of each stack shared with the
rest, a gated-GELU FFN (`wi_0`, `wi_1`), no absolute positions, an untied
head, and attention scores that are NOT scaled by 1/sqrt(d). v1.0
(t5-small/base/large) ties the head to the shared embedding, scaling the
decoder's output by ``d_model ** -0.5`` first, and has a single ReLU `wi`.
Parameter names follow the flax tree (`shared`, `enc_blocks.0.attention.wq`,
`dec_bias`, ...), so `t5_state_dict_from_flax` carries JAX weights across.

Attention goes through `ops.attention.dot_product_attention` at scale 1.0.
Every self-attention carries the relative bias, so it takes the plain path;
the decoder's cross-attention carries neither bias nor mask when the caller
passes no `attention_mask`, and at 1024 or more decoder tokens over an
encoder length that is a multiple of 128 it takes the flash gate: K3-K5
non-causal, over Sq != Skv, on the card. Decoding (`Seq2SeqGenerator`) runs
the decoder's self-attention over a `DecodeCache`, the cross-attention over
K/V projected from the encoder's output once per prompt.

The engine has no slot cache for T5 (`slot_serving` is False): it refuses
the model, as JAX's does. `T5LayeredApply` streams the model a block at a
time for big-model inference (`big_modeling`); the pipelined decomposition
(`T5PipelineApply`) waits for the port's pipeline work.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike
from ..ops.attention import DecodeCache, decode_cache_attention, decode_cache_mask, dot_product_attention
from ..ops.losses import global_mean
from ..ops.remat import maybe_remat
from ..parallel.tensor import HeadTable, tied_logits
from .decoder import Dense, _Call, call_with, flax_tree_to_state_dict, random_init
from .llama import RMSNorm


#: JAX's Megatron table for the family (`accelerate_tpu/models/t5.py`'s T5_SHARDING_RULES):
#: `(path regex, PartitionSpec)` over the flax tree's paths, first match
#: wins. `parallel.sharding.spec_for_param` reads it on the flax view of
#: the port's parameters.
T5_SHARDING_RULES = [
    (r"(wq|wk|wv)/kernel", (None, "model")),
    (r"wo/kernel", ("model", None)),
    (r"(wi_0|wi_1)/kernel", (None, "model")),
    (r"wo_ff/kernel", ("model", None)),
    (r"shared/embedding", ("model", None)),
    (r"lm_head/kernel", (None, "model")),
]


@dataclass
class T5Config:
    """JAX's fields the port runs (`param_dtype` is the factory's `dtype`;
    `decode_cache_length` is sized by `Seq2SeqGenerator`)."""

    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24  # encoder layers
    num_decoder_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    max_position_embeddings: int = 1024  # a practical bound for cache sizing; T5 has no absolute positions
    # v1.0 (t5-small/base/large): head tied to the shared embedding with a
    # d_model**-0.5 logit scale, single relu `wi` FFN. v1.1 (the default:
    # t5-v1_1-*, T0pp, flan-t5) unties the head and gates the FFN.
    tie_word_embeddings: bool = False
    feed_forward_proj: str = "gated-gelu"  # gated-gelu | relu

    def __post_init__(self):
        if self.feed_forward_proj not in ("gated-gelu", "relu"):
            # 'gated-relu' etc. exist in HF configs; silently building the
            # gated-GELU FFN for them would produce wrong logits with no error.
            raise ValueError(
                f"feed_forward_proj must be 'gated-gelu' (v1.1) or 'relu' (v1.0), "
                f"got {self.feed_forward_proj!r}"
            )


def relative_position_bucket(relative_position, bidirectional: bool, num_buckets: int, max_distance: int):
    """T5's log-bucketed relative positions, JAX's arithmetic op for op: the
    log in f32 of ``n / max_exact + 1e-6``, over the f32 log of
    ``max_distance / max_exact``, truncated toward zero by the int cast."""
    ret = 0
    n = -relative_position
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(torch.int32) * num_buckets
        n = n.abs()
    else:
        n = n.clamp_min(0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    log_ratio = torch.log(torch.tensor(max_distance / max_exact, dtype=torch.float32))
    val_if_large = max_exact + (
        torch.log(n.to(torch.float32) / max_exact + 1e-6) / log_ratio.to(n.device) * (num_buckets - max_exact)
    ).to(torch.int32)
    val_if_large = val_if_large.clamp_max(num_buckets - 1)
    return ret + torch.where(is_small, n.to(torch.int32), val_if_large)


class T5RelativeBias(HeadTable):
    """The learned relative-position bias table, ``[num_buckets, heads]``,
    one per stack (T5 keeps it on the stack's first block and shares it).
    Called on query and key positions, it gives the ``[1, heads, q, k]``
    additive score bias: under tensor parallel, the heads of this rank's
    attention chains (`HeadTable.table`)."""

    def __init__(self, cfg: T5Config, bidirectional: bool):
        super().__init__(cfg.relative_attention_num_buckets, cfg.num_heads)
        self.bidirectional = bidirectional
        self.max_distance = cfg.relative_attention_max_distance

    def forward(self, q_positions, k_positions):
        rel = k_positions[None, :] - q_positions[:, None]  # [q, k]
        buckets = relative_position_bucket(rel, self.bidirectional, self.num_embeddings, self.max_distance)
        # Head-major and contiguous: every layer's score add then reads the
        # bias along keys, not with a stride of the head count.
        return F.embedding(buckets.long(), self.table()).permute(2, 0, 1).contiguous()[None]


class T5Attention(nn.Module):
    """Bias-free q/k/v/o projections and attention at scale 1.0 over
    `hidden` (self-attention) or `kv_hidden` (cross-attention).

    With ``cache=(decode_cache, layer)``: self-attention writes this block's
    K/V into the decode cache and attends its written prefix under `mask`
    (`decode_cache_mask`); cross-attention projects the encoder's K/V on the
    first call and reads them back from ``decode_cache.cross`` after. They
    are kept head-major (``[B, H, S, D]`` storage seen as ``[B, S, H, D]``),
    the layout the plain attention multiplies in, so a step reads them
    without copying them. The head count is the projections' (a
    tensor-parallel rank's holds its own heads)."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.head_dim = cfg.d_kv
        self.wq, self.wk, self.wv = (Dense(cfg.d_model, inner, bias=False) for _ in range(3))
        self.wo = Dense(inner, cfg.d_model, bias=False)

    def _project_kv(self, src):
        b, s, _ = src.shape
        return (self.wk(src).reshape(b, s, -1, self.head_dim),
                self.wv(src).reshape(b, s, -1, self.head_dim))

    def forward(self, hidden, kv_hidden=None, bias=None, mask=None, causal=False, cache=None):
        b, s, _ = hidden.shape
        q = self.wq(hidden).reshape(b, s, -1, self.head_dim)
        if cache is not None and kv_hidden is not None:
            decode, layer = cache
            if layer not in decode.cross:
                decode.cross[layer] = tuple(x.transpose(1, 2).contiguous().transpose(1, 2)
                                            for x in self._project_kv(kv_hidden))
            k, v = decode.cross[layer]
            out = dot_product_attention(q, k, v, mask=mask, bias=bias, causal=False, scale=1.0)
        elif cache is not None:
            k, v = self._project_kv(hidden)
            out = decode_cache_attention(q, k, v, *cache, mask, bias=bias, scale=1.0)
        else:
            k, v = self._project_kv(hidden if kv_hidden is None else kv_hidden)
            out = dot_product_attention(q, k, v, mask=mask, bias=bias, causal=causal and kv_hidden is None,
                                        scale=1.0)
        return self.wo(out.reshape(b, s, -1))


class T5FF(nn.Module):
    """v1.1's gated-GELU (tanh approximation) ``wo_ff(gelu(wi_0 x) * wi_1
    x)``, or v1.0's ``wo_ff(relu(wi x))``."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.relu = cfg.feed_forward_proj == "relu"
        if self.relu:
            self.wi = Dense(cfg.d_model, cfg.d_ff, bias=False)
        else:
            self.wi_0 = Dense(cfg.d_model, cfg.d_ff, bias=False)
            self.wi_1 = Dense(cfg.d_model, cfg.d_ff, bias=False)
        self.wo_ff = Dense(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, hidden):
        if self.relu:
            mid = F.relu(self.wi(hidden))
        else:
            mid = F.gelu(self.wi_0(hidden), approximate="tanh") * self.wi_1(hidden)
        return self.wo_ff(mid)


class T5EncoderBlock(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.input_norm = RMSNorm(cfg.d_model, cfg.layer_norm_eps)
        self.attention = T5Attention(cfg)
        self.ff_norm = RMSNorm(cfg.d_model, cfg.layer_norm_eps)
        self.ff = T5FF(cfg)

    def forward(self, hidden, bias, mask):
        hidden = hidden + self.attention(self.input_norm(hidden), bias=bias, mask=mask)
        return hidden + self.ff(self.ff_norm(hidden))


class T5DecoderBlock(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.input_norm = RMSNorm(cfg.d_model, cfg.layer_norm_eps)
        self.self_attention = T5Attention(cfg)
        self.cross_norm = RMSNorm(cfg.d_model, cfg.layer_norm_eps)
        self.cross_attention = T5Attention(cfg)
        self.ff_norm = RMSNorm(cfg.d_model, cfg.layer_norm_eps)
        self.ff = T5FF(cfg)

    def forward(self, hidden, encoder_hidden, self_bias, enc_mask, self_mask=None, cache=None):
        """`self_mask` is the decode cache's mask when `cache` is given (the
        causal mask otherwise)."""
        hidden = hidden + self.self_attention(self.input_norm(hidden), bias=self_bias, mask=self_mask, causal=True,
                                              cache=cache)
        hidden = hidden + self.cross_attention(self.cross_norm(hidden), kv_hidden=encoder_hidden, mask=enc_mask,
                                               cache=cache)
        return hidden + self.ff(self.ff_norm(hidden))


def seq2seq_lm_loss(batch, apply_fn):
    """Teacher-forced cross-entropy on the decoder's targets; labels < 0 are
    ignored. `apply_fn(input_ids, decoder_input_ids, attention_mask)` gives
    the logits. The port of JAX's `seq2seq_lm_loss(params, batch, apply_fn)`."""
    logits = apply_fn(batch["input_ids"], batch["decoder_input_ids"], batch.get("attention_mask"))
    labels = batch["labels"].long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    valid = (labels >= 0).float()
    nll = -torch.gather(logp, -1, labels.clamp_min(0)[..., None])[..., 0]
    return global_mean(nll, valid)


def _encoder_mask(attention_mask):
    return None if attention_mask is None else attention_mask[:, None, None, :].bool()


class T5ForConditionalGeneration(nn.Module):
    """The encoder-decoder forward, whole (`forward(input_ids,
    decoder_input_ids, attention_mask)`, teacher-forced) or split as cached
    generation uses it: `encode` once, then `decode` a block at a time over
    a `DecodeCache` (`make_decode_cache`)."""

    sharding_rules = T5_SHARDING_RULES
    #: Tensor parallel over "model" splits this family (`parallel.tensor`):
    #: the attention and FFN blocks as chains (v1.0's `wo_ff` a row loner:
    #: no rule splits its `wi`), each stack's bias table read a rank's
    #: heads at a time (`head_table_readers`), the tied head through the
    #: split embedding.
    tensor_parallel = True

    loss_fn = staticmethod(seq2seq_lm_loss)
    slot_serving = False

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.config = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.enc_bias = T5RelativeBias(cfg, bidirectional=True)
        self.dec_bias = T5RelativeBias(cfg, bidirectional=False)
        self.enc_blocks = nn.ModuleList(T5EncoderBlock(cfg) for _ in range(cfg.num_layers))
        self.dec_blocks = nn.ModuleList(T5DecoderBlock(cfg) for _ in range(cfg.num_decoder_layers))
        self.enc_final_norm = RMSNorm(cfg.d_model, cfg.layer_norm_eps)
        self.dec_final_norm = RMSNorm(cfg.d_model, cfg.layer_norm_eps)
        self.lm_head = None if cfg.tie_word_embeddings else Dense(cfg.d_model, cfg.vocab_size, bias=False)

    def get_input_embeddings(self) -> nn.Embedding:
        return self.shared

    def head_table_readers(self):
        """{bias table: the attention blocks that add it}: the encoder's
        self-attentions and the decoder's (the cross-attention has none)."""
        return {"enc_bias": [b.attention for b in self.enc_blocks],
                "dec_bias": [b.self_attention for b in self.dec_blocks]}

    def _head(self, hidden):
        """v1.1: `lm_head`. v1.0: the shared embedding, after HF's
        ``d_model ** -0.5`` rescale (flax's `Embed.attend`, promoting)."""
        if self.lm_head is not None:
            return self.lm_head(hidden)
        x = hidden * (self.config.d_model ** -0.5)
        return tied_logits(self.shared, x.to(torch.promote_types(x.dtype, self.shared.weight.dtype)))

    def encode(self, input_ids, attention_mask=None):
        """[B, S] ids (and a [B, S] 1/0 mask) -> the encoder's [B, S, d_model] output."""
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        bias = self.enc_bias(pos, pos)
        mask = _encoder_mask(attention_mask)
        hidden = self.shared(input_ids)
        for block in self.enc_blocks:
            hidden = maybe_remat(block, hidden, bias, mask)
        return self.enc_final_norm(hidden)

    def decode(self, decoder_input_ids, encoder_hidden, positions=None, enc_mask=None,
               decode_cache: Optional[DecodeCache] = None):
        """[B, s] decoder ids -> [B, s, vocab] logits. `positions` ([s], the
        block's absolute decoder positions, shared by the batch) default to
        ``arange(s)``; `enc_mask` is ``[B, 1, 1, S_enc]`` bool or None. With
        `decode_cache` the block is written at the cache's index, which
        then advances by s, and the bias is taken against every written
        position (JAX's against ``arange(decode_cache_length)``, whose
        unwritten columns the mask hides)."""
        s = decoder_input_ids.shape[1]
        device = decoder_input_ids.device
        q_pos = torch.arange(s, device=device) if positions is None else positions.reshape(-1)
        self_mask = None
        if decode_cache is not None:
            self_mask = decode_cache_mask(decode_cache, s)
            k_pos = torch.arange(self_mask.shape[-1], device=device)
        else:
            k_pos = q_pos
        bias = self.dec_bias(q_pos, k_pos)
        hidden = self.shared(decoder_input_ids)
        for i, block in enumerate(self.dec_blocks):
            cache = None if decode_cache is None else (decode_cache, i)
            hidden = maybe_remat(block, hidden, encoder_hidden, bias, enc_mask, self_mask, cache)
        if decode_cache is not None:
            decode_cache.index += s
        return self._head(self.dec_final_norm(hidden))

    def forward(self, input_ids, decoder_input_ids, attention_mask=None):
        encoder_hidden = self.encode(input_ids, attention_mask)
        return self.decode(decoder_input_ids, encoder_hidden, enc_mask=_encoder_mask(attention_mask))

    def make_decode_cache(self, batch: int, max_length: int, dtype: Optional[torch.dtype] = None,
                          device=None) -> DecodeCache:
        """A zeroed decode cache for the decoder: `batch` rows of
        `max_length` positions, in `dtype` (the weights' by default) on
        `device` (the weights')."""
        cfg, weight = self.config, self.shared.weight
        return DecodeCache.create(cfg.num_decoder_layers, batch, max_length, cfg.num_heads, cfg.d_kv,
                                  dtype or weight.dtype, device or weight.device)


def _reject_tied_head(config: T5Config, what: str):
    """A v1.0 tied head lives in the shared embedding (the prelude), so the
    tail would need it too; JAX refuses that split, and so does the port."""
    if config.tie_word_embeddings:
        raise NotImplementedError(
            f"{what} does not support tie_word_embeddings=True (T5 v1.0): the tied head would replicate the "
            "shared embedding into the tail stage. Use the resident model path, or a v1.1 checkpoint."
        )


class T5LayeredApply:
    """T5 streamed a block at a time (JAX's `T5LayeredApply`): the layers
    are the encoder's blocks, then the decoder's; an entry's names carry
    its kind (``enc.`` or ``dec.``), and the first decoder entry also
    carries ``enc_final_norm``, applied to the encoder's output once,
    before any cross-attention reads it. Each part runs the port's own
    modules (a one-block skeleton on the meta device) through
    `torch.func.functional_call`, so the stream computes the model's
    forward op for op."""

    def __init__(self, config: T5Config):
        _reject_tied_head(config, "T5LayeredApply (tier-streamed execution)")
        self.config = config
        with torch.device("meta"):
            self._skeleton = T5ForConditionalGeneration(dataclasses.replace(config, num_layers=1,
                                                                            num_decoder_layers=1))
        self._tail = _Call(self._skeleton, lambda m, hidden: m._head(m.dec_final_norm(hidden)))

    def split(self, params):
        cfg = self.config

        def under(prefix):
            return {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}

        prelude = {k: v for k, v in params.items() if k.split(".")[0] in ("shared", "enc_bias", "dec_bias")}
        layers = [{f"enc.{k}": v for k, v in under(f"enc_blocks.{i}.").items()} for i in range(cfg.num_layers)]
        for i in range(cfg.num_decoder_layers):
            entry = {f"dec.{k}": v for k, v in under(f"dec_blocks.{i}.").items()}
            if i == 0:
                entry.update({k: v for k, v in params.items() if k.startswith("enc_final_norm.")})
            layers.append(entry)
        tail = {k: v for k, v in params.items() if k.split(".")[0] in ("dec_final_norm", "lm_head")}
        return prelude, layers, tail

    def join(self, prelude, layers, tail):
        cfg = self.config
        out = dict(prelude)
        for i, entry in enumerate(layers):
            stack, j = ("enc_blocks", i) if i < cfg.num_layers else ("dec_blocks", i - cfg.num_layers)
            for k, v in entry.items():
                out[k if k.startswith("enc_final_norm.") else f"{stack}.{j}.{k.split('.', 1)[1]}"] = v
        out.update(tail)
        return out

    def apply_prelude(self, prelude_params, input_ids, decoder_input_ids, attention_mask=None):
        m = self._skeleton
        enc_pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        dec_pos = torch.arange(decoder_input_ids.shape[1], device=input_ids.device)

        def under(prefix):
            return {k[len(prefix):]: v for k, v in prelude_params.items() if k.startswith(prefix)}

        shared = under("shared.")
        return {
            "enc": call_with(m.shared, shared, input_ids),
            "dec": call_with(m.shared, shared, decoder_input_ids),
            "enc_bias": call_with(m.enc_bias, under("enc_bias."), enc_pos, enc_pos),
            "dec_bias": call_with(m.dec_bias, under("dec_bias."), dec_pos, dec_pos),
            "enc_mask": _encoder_mask(attention_mask),
        }

    def apply_layer(self, layer_params, carry):
        m = self._skeleton
        carry = dict(carry)

        def under(prefix):
            return {k[len(prefix):]: v for k, v in layer_params.items() if k.startswith(prefix)}

        enc = under("enc.")
        if enc:
            carry["enc"] = call_with(m.enc_blocks[0], enc, carry["enc"], carry["enc_bias"], carry["enc_mask"])
            return carry
        norm = under("enc_final_norm.")
        if norm:
            carry["enc"] = call_with(m.enc_final_norm, norm, carry["enc"])
        carry["dec"] = call_with(m.dec_blocks[0], under("dec."), carry["dec"], carry["enc"], carry["dec_bias"],
                                 carry["enc_mask"], None, None)
        return carry

    def apply_tail(self, tail_params, carry):
        return call_with(self._tail, tail_params, carry["dec"], prefix="model.")


@torch.no_grad()
def create_t5_model(
    config: Optional[T5Config] = None,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> T5ForConditionalGeneration:
    """A T5 with random weights drawn from `seed`, made in `dtype` on
    `device` (``cuda`` unless ``device="cpu"``), after flax's initial
    distributions: Dense weights normal with std 1/sqrt(fan_in), the shared
    embedding with std 1/sqrt(d_model), the relative-bias tables with std 1,
    norms ones (`decoder.random_init`: T0pp-11B is 22.3 GB in bf16 and never
    exists in f32)."""
    config = config or t5_tiny()
    embed_std = config.d_model ** -0.5
    return random_init(lambda: T5ForConditionalGeneration(config), seed, dtype, device,
                       embed_std=lambda m: 1.0 if isinstance(m, T5RelativeBias) else embed_std)


def t5_state_dict_from_flax(params, config: T5Config):
    """The port's `state_dict` from a JAX T5 params tree (numpy arrays).
    With ``tie_word_embeddings`` the head is the shared embedding and a
    distinct ``lm_head`` in the tree is an error; without it ``lm_head`` is
    required."""
    tree = params["params"] if "params" in params else params
    for prefix, n in (("enc_blocks_", config.num_layers), ("dec_blocks_", config.num_decoder_layers)):
        n_tree = sum(k.startswith(prefix) for k in tree)
        if n_tree != n:
            raise ValueError(f"params tree has {n_tree} {prefix[:-1]}, the config {n}")
    if config.tie_word_embeddings and "lm_head" in tree:
        raise ValueError("tie_word_embeddings=True but the params tree carries a distinct lm_head; refusing to drop it")
    if not config.tie_word_embeddings and "lm_head" not in tree:
        raise ValueError("tie_word_embeddings=False but the params tree has no lm_head")
    return flax_tree_to_state_dict(tree)


def t0pp_11b() -> T5Config:
    """bigscience/T0pp dims (T5 v1.1 xxl; reference benchmarks/README.md:35)."""
    return T5Config()


def t5_tiny() -> T5Config:
    return T5Config(
        vocab_size=512,
        d_model=64,
        d_kv=16,
        d_ff=128,
        num_layers=2,
        num_decoder_layers=2,
        num_heads=4,
        max_position_embeddings=128,
    )


def t5_small_v1_0() -> T5Config:
    """google-t5/t5-small dims: the v1.0 layout (tied head, relu FFN)."""
    return T5Config(
        d_model=512,
        d_kv=64,
        d_ff=2048,
        num_layers=6,
        num_decoder_layers=6,
        num_heads=8,
        tie_word_embeddings=True,
        feed_forward_proj="relu",
    )


def t5_tiny_v1_0() -> T5Config:
    return dataclasses.replace(t5_tiny(), tie_word_embeddings=True, feed_forward_proj="relu")
