"""BERT-family encoder in PyTorch: the port of `accelerate_tpu/models/bert.py`,
the model of the `nlp_example` (sequence classification).

Post-LN layers with a fused ``qkv`` projection, tanh GELU and fp32
LayerNorms; word + position + token-type embeddings; a tanh pooler over
the first token. Parameter names follow the flax tree (`qkv`, `attn_out`,
`attn_ln`, `mlp_up`, `mlp_down`, `mlp_ln`, `pooler`, `classifier`), so
`bert_state_dict_from_flax` carries JAX weights across key for key.

The dtype flow is the JAX package's, which `torch.autocast` would not give.
Under a bf16 `PreparedModel` the parameters arrive as bf16 copies:

  - the embedding sum is bf16, in JAX's order ``(words + positions) + types``;
  - each LayerNorm (flax's ``dtype=jnp.float32``) computes in f32 from its
    bf16-rounded scale and bias and returns f32;
  - each `Dense` after it promotes as flax's ``Dense(dtype=None)`` does:
    an f32 input and a bf16 weight run in f32 on the bf16-rounded weight.

So from the first LayerNorm on every matmul of a bf16 BERT runs in f32, as
in the JAX package (ROADMAP C). Attention is the plain masked path of
`ops/attention.py`: BERT passes a padding mask or runs at S <= 512, and
either keeps the flash gate shut, as in JAX. The layer loop goes through
`ops.remat.maybe_remat`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, make_generator, resolve_device
from ..ops.attention import dot_product_attention
from ..ops.losses import global_mean
from ..ops.remat import maybe_remat
from .decoder import Dense

#: The std of a unit normal truncated to [-2, 2], which flax's lecun_normal
#: divides out so that its draws keep variance 1 / fan_in.
_TRUNCATED_STD = 0.87962566103423978


#: JAX's Megatron table for the family (`accelerate_tpu/models/bert.py`'s BERT_SHARDING_RULES):
#: `(path regex, PartitionSpec)` over the flax tree's paths, first match
#: wins. `parallel.sharding.spec_for_param` reads it on the flax view of
#: the port's parameters.
BERT_SHARDING_RULES = [
    (r"qkv/kernel", (None, "model")),
    (r"attn_out/kernel", ("model", None)),
    (r"mlp_up/kernel", (None, "model")),
    (r"mlp_down/kernel", ("model", None)),
    (r"word_embeddings/embedding", ("model", None)),
]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    num_labels: int = 2
    dtype: Optional[str] = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm(dtype=jnp.float32)``: statistics, scale, bias
    and output in f32. flax takes the variance as E[x^2] - E[x]^2, torch's
    `layer_norm` as the mean square deviation; BERT's logits agree within
    1e-5 either way (`tests/test_torch_bert.py`)."""

    def __init__(self, hidden: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(hidden))
        self.bias = nn.Parameter(torch.zeros(hidden))

    def forward(self, x):
        return F.layer_norm(x.float(), self.weight.shape, self.weight.float(), self.bias.float(), self.eps)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.qkv = Dense(cfg.hidden_size, 3 * cfg.hidden_size)
        # q | k | v: a tensor-parallel chain gives each rank its heads of each.
        self.qkv.fused_parts = 3
        self.attn_out = Dense(cfg.hidden_size, cfg.hidden_size)

    def forward(self, hidden, mask):
        b, s, _ = hidden.shape
        # The head count is the projection's (a tensor-parallel rank's holds its own heads).
        q, k, v = (t.reshape(b, s, -1, self.cfg.head_dim) for t in self.qkv(hidden).chunk(3, dim=-1))
        out = dot_product_attention(q, k, v, mask=mask)
        return self.attn_out(out.reshape(b, s, -1))


class BertLayer(nn.Module):
    """Post-LN: ``ln(x + attn(x))``, then ``ln(x + mlp(x))``."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attention = BertSelfAttention(cfg)
        self.attn_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.mlp_up = Dense(cfg.hidden_size, cfg.intermediate_size)
        self.mlp_down = Dense(cfg.intermediate_size, cfg.hidden_size)
        self.mlp_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, hidden, mask):
        hidden = self.attn_ln(hidden + self.attention(hidden, mask))
        up = F.gelu(self.mlp_up(hidden), approximate="tanh")
        return self.mlp_ln(hidden + self.mlp_down(up))


class BertEncoder(nn.Module):
    """Embeddings and the layer stack; returns (sequence output, pooled output)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size)
        self.embeddings_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.layers = nn.ModuleList(BertLayer(cfg) for _ in range(cfg.num_hidden_layers))
        self.pooler = Dense(cfg.hidden_size, cfg.hidden_size)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        s = input_ids.shape[1]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        words = self.word_embeddings(input_ids)
        positions = self.position_embeddings(torch.arange(s, device=input_ids.device))[None]
        hidden = self.embeddings_ln(words + positions + self.token_type_embeddings(token_type_ids))
        for layer in self.layers:
            hidden = maybe_remat(layer, hidden, attention_mask)
        return hidden, torch.tanh(self.pooler(hidden[:, 0]))


def sequence_classification_loss(batch, apply_fn):
    """Mean softmax cross-entropy of the f32 logits against ``batch["labels"]``;
    `apply_fn(input_ids, attention_mask, token_type_ids)` gives the logits.
    The port of JAX's `sequence_classification_loss(params, batch, apply_fn)`,
    with the parameters implicit in the module."""
    logits = apply_fn(batch["input_ids"], batch.get("attention_mask"), batch.get("token_type_ids"))
    logp = torch.log_softmax(logits.float(), dim=-1)
    return global_mean(-torch.gather(logp, -1, batch["labels"].long()[:, None])[:, 0])


class BertForSequenceClassification(nn.Module):

    sharding_rules = BERT_SHARDING_RULES
    #: Tensor parallel over "model" splits this family (`parallel.tensor`;
    #: the fused `qkv` a rank's heads of q, k and v in a chain).
    tensor_parallel = True

    #: The loss `Accelerator.prepare` bundles with this model, as JAX's
    #: `create_bert_model` bundles it.
    loss_fn = staticmethod(sequence_classification_loss)

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.config = cfg
        self.bert = BertEncoder(cfg)
        self.classifier = Dense(cfg.hidden_size, cfg.num_labels)

    def get_input_embeddings(self) -> nn.Embedding:
        return self.bert.word_embeddings

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        """[B, S] token ids -> [B, num_labels] logits. `attention_mask` is a
        [B, S] padding mask of 0/1 (1 = a real token) or None."""
        _, pooled = self.bert(input_ids, attention_mask, token_type_ids)
        return self.classifier(pooled)


@torch.no_grad()
def create_bert_model(
    config: Optional[BertConfig] = None,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> BertForSequenceClassification:
    """A BERT classifier with random weights drawn from `seed` on `device`
    (``cuda`` unless the caller passes ``device="cpu"``), in flax's
    distributions: Dense weights lecun-normal (a normal truncated to two
    standard deviations, variance 1 / fan_in), biases zero, embeddings
    normal with std 1/sqrt(hidden), LayerNorms ones and zeros. The modules
    are built without storage and filled from one explicit generator."""
    dev = resolve_device(device)
    config = config or BertConfig()
    with torch.device("meta"):
        model = BertForSequenceClassification(config)
    model = model.to_empty(device=dev)
    gen = make_generator(seed, dev)
    for module in model.modules():
        if isinstance(module, Dense):
            std = module.in_features ** -0.5 / _TRUNCATED_STD
            nn.init.trunc_normal_(module.weight, 0.0, std, -2 * std, 2 * std, generator=gen)
            module.bias.zero_()
        elif isinstance(module, nn.Embedding):
            module.weight.normal_(0.0, 1.0 / math.sqrt(config.hidden_size), generator=gen)
        elif isinstance(module, LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
    return model.to(dtype).eval()


def bert_state_dict_from_flax(params, config: BertConfig):
    """The port's `state_dict` from a JAX BERT classifier's params tree given
    as numpy arrays (``{"params": {"bert": ..., "classifier": ...}}``).
    Flax `Dense` kernels are [in, out] and `nn.Linear` weights [out, in], so
    every kernel is transposed; LayerNorm ``scale`` becomes ``weight``."""
    tree = params["params"] if "params" in params else params

    def t(x):
        return torch.from_numpy(np.array(x))

    def dense(prefix, node):
        return {prefix + "weight": t(node["kernel"]).T.contiguous(), prefix + "bias": t(node["bias"])}

    def norm(prefix, node):
        return {prefix + "weight": t(node["scale"]), prefix + "bias": t(node["bias"])}

    enc = tree["bert"]
    n_tree = sum(k.startswith("layer_") for k in enc)
    if n_tree != config.num_hidden_layers:
        raise ValueError(
            f"params tree has {n_tree} layers, config.num_hidden_layers is {config.num_hidden_layers}"
        )
    sd = {f"bert.{name}.weight": t(enc[name]["embedding"])
          for name in ("word_embeddings", "position_embeddings", "token_type_embeddings")}
    sd.update(norm("bert.embeddings_ln.", enc["embeddings_ln"]))
    for i in range(config.num_hidden_layers):
        lp, pre = enc[f"layer_{i}"], f"bert.layers.{i}."
        sd.update(dense(pre + "attention.qkv.", lp["attention"]["qkv"]))
        sd.update(dense(pre + "attention.attn_out.", lp["attention"]["attn_out"]))
        for name in ("mlp_up", "mlp_down"):
            sd.update(dense(pre + f"{name}.", lp[name]))
        for name in ("attn_ln", "mlp_ln"):
            sd.update(norm(pre + f"{name}.", lp[name]))
    sd.update(dense("bert.pooler.", enc["pooler"]))
    sd.update(dense("classifier.", tree["classifier"]))
    return sd


def bert_base(num_labels: int = 2) -> BertConfig:
    return BertConfig(num_labels=num_labels)


def bert_tiny(num_labels: int = 2) -> BertConfig:
    """4-layer test-size config."""
    return BertConfig(
        vocab_size=1024,
        hidden_size=128,
        num_hidden_layers=4,
        num_attention_heads=4,
        intermediate_size=512,
        max_position_embeddings=128,
        num_labels=num_labels,
    )
