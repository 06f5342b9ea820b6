"""Tensor parallel over the mesh's "model" axis: Megatron's building blocks,
placed by a rules table (the port of what GSPMD does for the JAX package
when a parameter's `PartitionSpec` names "model").

JAX states the layout as specs on the flax tree (the family's hand table,
`LLAMA_SHARDING_RULES`, or the planner's, `parallel.planner`) and lets XLA
insert the collectives. The port, which runs one process a rank, applies
the same table to the module (`shard_module`): each rule-matched layer is
replaced by its rank's split, whose forward issues the collectives
Megatron's layers issue.

  - A flax kernel is [in, out] and a torch weight [out, in]: a kernel split
    on its output dim (``(None, "model")``) is a column-parallel layer, the
    torch weight's rows split; on its input dim (``("model", None)``) a
    row-parallel layer, the columns split. A bias splits with a column
    layer's output and stays whole beside a row layer.
  - A chain: in one block (the layers of one parent module), column layers
    and one row layer. The columns' input enters through `copy_to_model`
    (identity forward, all-reduce backward) and their outputs stay split
    by head or hidden unit into the row layer, whose partial products
    `reduce_from_model` sums (all-reduce forward, identity backward) in f32,
    twice a bf16 product's bytes (GSPMD sums a bf16 dot in bf16); the bias,
    whole, is added after the sum, and the result rounded once to the
    product's dtype.
  - A loner column layer (no row layer in its block: the head) gathers its
    output over "model" (`gather_from_model`), since its consumer reads it
    whole: the loss and the sampler see JAX's full logits.
  - A loner row layer (its block's other layers whole) takes this rank's
    part of its whole input (`split_to_model`: the gradient all-gathered)
    and all-reduces its product.
  - An embedding split on its vocab rows (``("model", None)``) holds rows
    [start, stop): an id outside them reads a zero row, and the all-reduce
    sums the one rank that holds it. Split on its hidden columns
    (``(None, "model")``) it looks up this rank's columns and all-gathers
    the hidden dim. A tied head over either table is the matching product:
    logits gathered over the vocab, or partial logits over this rank's
    hidden part all-reduced.
  - An attention block the table does not split as a chain (a replicated
    chain, or loners) computes every head; under a cache (the engine's pools hold this
    rank's KV heads only) it writes and attends over this rank's heads and
    all-gathers the attention output before its whole output projection
    (`HeadSplit`). Without a cache (training) it runs whole.
  - An `Int8Linear` (the int8 engine's) splits its int8 matrix like the
    kernel and its per-output-channel scale by the rule's output dim, as
    JAX's `derive_tp_param_shardings` places ``kernel/scale``.
  - A fused column layer (``fused_parts`` > 1 on the layer: BERT's ``qkv``,
    q | k | v in one kernel) in a chain gives each rank its run of each part
    (q_r | k_r | v_r: its heads of each), where JAX's spec splits the
    kernel's columns in one contiguous run and GSPMD moves the heads; the
    bytes a rank holds are the spec's. As a loner it splits contiguously,
    as the spec does, since its output is gathered whole. `TPSplit` names
    the layout; `split_part` and `join_parts` cut a whole tensor to it and
    put the parts back in JAX's order.
  - A table that the attention blocks read a head at a time (T5's
    relative-position bias, ``[buckets, heads]``) takes this rank's heads
    where its blocks are chains (`head_table`): its gradient is then this
    rank's heads only, so the table enters through `copy_to_model` and
    every rank holds the summed gradient. Split by a rule, it is gathered
    whole first (the gradient keeps this rank's part).

A spec that fits none of these raises, naming the leaf. The attention and
MLP modules read their per-rank head counts and widths off their layers'
shapes, so the rotary embedding, the grouped-query grouping and `attend`
(K1-K5 included) see only the rank's heads. At a "model" size of 1
`shard_module` changes nothing: the layers stay plain, and no collective
runs. `COLLECTIVES` counts the collectives issued, by kind (every rank of
a group must issue the same sequence).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops.quantization import Int8Linear
from .sharding import _flax_module_path, _leaf, spec_for_param, tp_spec

#: The ROADMAP A item 3 bullet for the one family whose forward has no tensor-parallel split yet.
OTHER_FAMILIES = "ROADMAP A item 3, expert sharding (Mixtral's experts and router over \"model\")"

#: Collectives issued by the blocks, by kind.
COLLECTIVES: Dict[str, int] = {"all_reduce": 0, "all_gather": 0}


def reset_collectives():
    for key in COLLECTIVES:
        COLLECTIVES[key] = 0


class TPGroup:
    """The "model" process group of one rank: `group` (None for the default
    group), this rank's index in it and its size."""

    def __init__(self, group=None):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def __deepcopy__(self, memo):
        return self  # a process group is not copied with a module

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        COLLECTIVES["all_reduce"] += 1
        x = x.contiguous()
        dist.all_reduce(x, group=self.group)
        return x

    def all_gather_last(self, x: torch.Tensor) -> torch.Tensor:
        COLLECTIVES["all_gather"] += 1
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim=-1)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over "model" (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.tp.all_reduce(grad.clone()), None


class _ReduceFromModel(torch.autograd.Function):
    """The partial products summed over "model"; identity backward (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, tp):
        return tp.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SplitToModel(torch.autograd.Function):
    """This rank's part of the last dim; the gradient all-gathered over
    "model" (Megatron's scatter to the model-parallel region)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        width = x.shape[-1] // tp.size
        return x[..., tp.rank * width:(tp.rank + 1) * width].contiguous()

    @staticmethod
    def backward(ctx, grad):
        return ctx.tp.all_gather_last(grad), None


class _GatherFromModel(torch.autograd.Function):
    """The last dim gathered over "model"; the backward takes this rank's
    part (every rank computes the same loss on the gathered tensor)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp, ctx.width = tp, x.shape[-1]
        return tp.all_gather_last(x)

    @staticmethod
    def backward(ctx, grad):
        start = ctx.tp.rank * ctx.width
        return grad[..., start:start + ctx.width].contiguous(), None


def copy_to_model(x, tp: TPGroup):
    return _CopyToModel.apply(x, tp)


def reduce_from_model(x, tp: TPGroup):
    return _ReduceFromModel.apply(x, tp)


def gather_from_model(x, tp: TPGroup):
    return _GatherFromModel.apply(x, tp)


def split_to_model(x, tp: TPGroup):
    return _SplitToModel.apply(x, tp)


class ColumnParallel:
    """A linear layer holding the rows of its torch weight (the flax
    kernel's output columns) this rank owns."""

    tp: TPGroup
    gather_output: bool = False

    def forward(self, x):
        y = super().forward(copy_to_model(x, self.tp))
        return gather_from_model(y, self.tp) if self.gather_output else y


class RowParallel:
    """A linear layer holding the columns of its torch weight (the flax
    kernel's input rows) this rank owns; the bias, whole, is added after
    the sum. A loner (`split_input`) takes this rank's part of a whole
    input first."""

    tp: TPGroup
    split_input: bool = False

    def _product(self, x):
        raise NotImplementedError

    def forward(self, x):
        if self.split_input:
            x = split_to_model(x, self.tp)
        part = self._product(x)
        # Summed and biased in f32, rounded once to the product's dtype, as
        # one GEMM's epilogue rounds: a bf16 sum rounds the partials and the
        # sum apart (on an H100, OPT-30B's pre-clip norms at model=2 part from
        # tp=1's by 1.36e-3 with a bf16 sum, with the bias added in bf16 or
        # f32 alike, and by 2.5e-4 with this one).
        y = reduce_from_model(part.float(), self.tp)
        y = y if self.bias is None else y + self.bias.float()
        return y.to(part.dtype)


class ColumnParallelLinear(ColumnParallel, nn.Linear):
    pass


class RowParallelLinear(RowParallel, nn.Linear):
    def _product(self, x):
        return F.linear(x, self.weight)


def _dense():
    from ..models.decoder import Dense

    return Dense


class ColumnParallelInt8Linear(ColumnParallel, Int8Linear):
    pass


class RowParallelInt8Linear(RowParallel, Int8Linear):
    def _product(self, x):
        return (F.linear(x, self.q.to(x.dtype)).float() * self.scale).to(x.dtype)


_DENSE_CLASSES: Dict[str, type] = {}


def _dense_classes():
    """The column- and row-parallel forms of the models' `Dense` (flax's
    promoting dense), made once."""
    if not _DENSE_CLASSES:
        dense = _dense()

        class ColumnParallelDense(ColumnParallel, dense):
            pass

        class RowParallelDense(RowParallel, dense):
            def _product(self, x):
                dtype = torch.promote_types(x.dtype, self.weight.dtype)
                return F.linear(x.to(dtype), self.weight.to(dtype))

        _DENSE_CLASSES.update(column=ColumnParallelDense, row=RowParallelDense)
    return _DENSE_CLASSES["column"], _DENSE_CLASSES["row"]


class VocabParallelEmbedding(nn.Embedding):
    """Rows [vocab_start, vocab_start + rows) of an embedding table: an id
    outside them reads zeros, and the all-reduce gives every rank the row
    of the rank that holds it. `logits` is the tied head over the same
    rows, gathered over the vocab."""

    tp: TPGroup
    vocab_start: int = 0

    def forward(self, ids):
        local = ids - self.vocab_start
        inside = (local >= 0) & (local < self.num_embeddings)
        rows = F.embedding(torch.where(inside, local, torch.zeros_like(local)), self.weight)
        return reduce_from_model(rows * inside[..., None].to(rows.dtype), self.tp)

    def logits(self, hidden):
        weight = self.weight.to(hidden.dtype)
        return gather_from_model(copy_to_model(hidden, self.tp) @ weight.T, self.tp)


class HiddenParallelEmbedding(nn.Embedding):
    """Columns [r·H/tp, (r+1)·H/tp) of an embedding table: each rank looks
    up its columns and the hidden dim is all-gathered (the backward keeps
    this rank's part). `logits` is the tied head over the same columns:
    this rank's part of the hidden times its columns, all-reduced."""

    tp: TPGroup

    def forward(self, ids):
        return gather_from_model(F.embedding(ids, self.weight), self.tp)

    def logits(self, hidden):
        weight = self.weight.to(hidden.dtype)
        return reduce_from_model(split_to_model(hidden, self.tp) @ weight.T, self.tp)


def tied_logits(embedding: nn.Embedding, hidden):
    """A head tied to `embedding`: ``hidden @ weight.T`` in `hidden`'s
    dtype, or a split table's own head (its rows' logits gathered over the
    vocab, or its columns' partial logits all-reduced)."""
    tied = getattr(embedding, "logits", None)
    return tied(hidden) if tied is not None else hidden @ embedding.weight.T.to(hidden.dtype)


class HeadSplit:
    """The "model" group of an attention block whose projections stay whole
    (a replicated chain). Under a cache (the engine's pools or its
    prefill's dense pair, which hold this rank's KV heads only) the block
    attends over this rank's query heads and KV heads (`attend`, K1/K2 on
    this rank's heads) and all-gathers the output's heads; without one it
    attends over every head."""

    def __init__(self, tp: TPGroup):
        self.tp = tp

    def __deepcopy__(self, memo):
        return self

    def attend(self, q, k, v, positions, attention_mask=None, kv_pool=None, page_table=None,
               attention_impl="gather", kv_cache=None, decode_cache=None):
        from ..ops.attention import attend

        if kv_pool is None and kv_cache is None:
            return attend(q, k, v, positions, attention_mask, kv_pool, page_table, attention_impl, kv_cache,
                          decode_cache)
        n, r = self.tp.size, self.tp.rank
        q, k, v = (t.chunk(n, dim=2)[r] for t in (q, k, v))
        out = attend(q, k, v, positions, attention_mask, kv_pool, page_table, attention_impl, kv_cache,
                     decode_cache)
        b, s, h, d = out.shape
        return gather_from_model(out.reshape(b, s, h * d), self.tp).reshape(b, s, h * n, d)


def attend_heads(block: nn.Module, q, k, v, positions, *modes):
    """`attend` for an attention block: through its `HeadSplit` when
    `shard_module` gave it one."""
    split = getattr(block, "tp_heads", None)
    if split is None:
        from ..ops.attention import attend

        return attend(q, k, v, positions, *modes)
    return split.attend(q, k, v, positions, *modes)


class TPSplit(NamedTuple):
    """How a tensor is split over "model": on torch dim `dim`, each rank
    holding its chunk of each of `parts` equal runs (1: one contiguous
    chunk)."""

    dim: int
    parts: int = 1


def split_part(full: torch.Tensor, split: TPSplit, size: int, rank: int) -> torch.Tensor:
    """Rank `rank`'s part of a whole tensor under `split` over `size` ranks."""
    runs = full.unflatten(split.dim, (split.parts, -1))
    return runs.chunk(size, dim=split.dim + 1)[rank].flatten(split.dim, split.dim + 1)


def join_parts(parts: Sequence[torch.Tensor], split: TPSplit) -> torch.Tensor:
    """The whole tensor from every rank's part under `split`, in rank order
    (JAX's layout: each run whole, the runs in order)."""
    runs = [p.unflatten(split.dim, (split.parts, -1)) for p in parts]
    return torch.cat(runs, dim=split.dim + 1).flatten(split.dim, split.dim + 1)


def _param(value: torch.Tensor, like: nn.Parameter) -> nn.Parameter:
    return nn.Parameter(value.detach().clone(), requires_grad=like.requires_grad)


def _split(t: torch.Tensor, dim: int, tp: TPGroup, parts: int = 1) -> torch.Tensor:
    return split_part(t, TPSplit(dim, parts), tp.size, tp.rank)


def _fused_parts(layer, kind: str, loner: bool) -> int:
    """The runs a column layer's output splits into on each rank: its
    ``fused_parts`` in a chain, else 1."""
    return getattr(layer, "fused_parts", 1) if kind == "column" and not loner else 1


def _linear_split(layer, kind: str, tp: TPGroup, loner: bool):
    """`layer` (an `nn.Linear`, a `Dense` or an `Int8Linear`) as its
    rank's column- or row-parallel split; a `loner` column layer gathers
    its output, a loner row layer takes its part of a whole input. A fused
    column layer in a chain takes its run of each part."""
    column = kind == "column"
    parts = _fused_parts(layer, kind, loner)
    if isinstance(layer, Int8Linear):
        cls = ColumnParallelInt8Linear if column else RowParallelInt8Linear
        q = _split(layer.q, 0 if column else 1, tp).clone()
        scale = _split(layer.scale, 0, tp).clone() if column else layer.scale
        bias = None if layer.bias is None else (_split(layer.bias, 0, tp).clone() if column else layer.bias)
        new = cls(q, scale, bias)
    else:
        dense = _dense()
        if isinstance(layer, dense):
            cls = _dense_classes()[0 if column else 1]
        elif type(layer) is nn.Linear:
            cls = ColumnParallelLinear if column else RowParallelLinear
        else:
            raise NotImplementedError(f"no tensor-parallel form of {type(layer).__name__}")
        weight = _split(layer.weight, 0 if column else 1, tp, parts)
        with torch.device("meta"):
            new = cls(weight.shape[1], weight.shape[0], bias=layer.bias is not None)
        new.weight = _param(weight, layer.weight)
        if layer.bias is not None:
            new.bias = _param(_split(layer.bias, 0, tp, parts) if column else layer.bias, layer.bias)
    new.tp = tp
    if column:
        new.gather_output = loner
    else:
        new.split_input = loner
    return new


def _embedding_split(layer: nn.Embedding, dim: int, tp: TPGroup) -> nn.Embedding:
    """The vocab-parallel (`dim` 0) or hidden-parallel (`dim` 1) split of
    an embedding table; a head table (`HeadTable`) keeps its class and
    holds its split (see `HeadTable.table`)."""
    weight = _split(layer.weight, dim, tp)
    if isinstance(layer, HeadTable):
        layer.weight = _param(weight, layer.weight)
        layer.tp, layer.split_dim = tp, dim
        return layer
    with torch.device("meta"):
        new = (VocabParallelEmbedding if dim == 0 else HiddenParallelEmbedding)(weight.shape[0], weight.shape[1])
    new.weight = _param(weight, layer.weight)
    new.tp = tp
    if dim == 0:
        new.vocab_start = tp.rank * weight.shape[0]
    return new


class HeadTable(nn.Embedding):
    """An embedding table whose columns are attention heads, read whole by
    blocks that compute every head and a rank's heads by chains (T5's
    relative-position bias). `shard_module` gives it its "model" group
    (`tp`), the torch dim a rule splits it on (`split_dim`, or None) and
    whether its blocks are chains (`chain`); `table()` is what a forward
    reads: this rank's heads in a chain, every head otherwise."""

    tp: Optional[TPGroup] = None
    split_dim: Optional[int] = None
    chain: bool = False

    def table(self) -> torch.Tensor:
        weight, tp = self.weight, self.tp
        if tp is None:
            return weight
        if self.split_dim == 0:  # buckets split: gathered whole, the gradient keeps this rank's rows
            weight = gather_from_model(weight.T, tp).T
        elif self.split_dim == 1 and not self.chain:  # heads split, every head read: gathered
            weight = gather_from_model(weight, tp)
        if self.chain and self.split_dim != 1:
            # This rank's heads of the whole table; the gradient summed over "model".
            heads = weight.shape[1] // tp.size
            weight = copy_to_model(weight, tp)[:, tp.rank * heads:(tp.rank + 1) * heads]
        return weight


def _head_tables(module: nn.Module, tp: TPGroup):
    """Tell each `HeadTable` of `module` its group and whether the blocks
    that read it are chains: the model names them (``head_table_readers()``:
    {table's name: [attention blocks]}); a table whose readers mix chains
    and whole blocks raises."""
    readers = getattr(module, "head_table_readers", None)
    for name, blocks in (readers() if readers is not None else {}).items():
        table = module.get_submodule(name)
        chains = {getattr(b, "tp_heads", None) is None and isinstance(b.wq, ColumnParallel)
                  and not b.wq.gather_output for b in blocks}
        if len(chains) > 1:
            raise NotImplementedError(f"{name}: its attention blocks are split as chains and whole at once")
        table.tp, table.chain = tp, chains == {True}


def refuse_family(module: nn.Module):
    """A family whose forward has no tensor-parallel split (Mixtral) raises,
    naming the bullet that ports it."""
    if not getattr(module, "tensor_parallel", False):
        raise NotImplementedError(
            f"{type(module).__name__} over a \"model\" axis above 1 waits for {OTHER_FAMILIES}")


_KINDS = {(None, "model"): "column", ("model",): "row", ("model", None): "row"}
_EMBEDDING_DIMS = {("model",): 0, ("model", None): 0, (None, "model"): 1}
_ATTENTION = ("wq", "wk", "wv", "wo")


def _chains(kinds: Dict[str, Optional[str]]) -> Dict[str, bool]:
    """{name: loner} of the split linear layers, from {name: "column",
    "row" or None (whole)} of every linear layer: a block (one parent's
    layers) with one row layer and every other layer column is a chain; a
    row layer among whole ones, or column layers without a row one, are
    loners. Any other mix raises."""
    blocks: Dict[str, Dict[str, Optional[str]]] = {}
    for name, kind in kinds.items():
        blocks.setdefault(name.rpartition(".")[0], {})[name] = kind
    loner = {}
    for block, members in blocks.items():
        rows = [n for n, k in members.items() if k == "row"]
        cols = [n for n, k in members.items() if k == "column"]
        if len(rows) > 1 or (rows and cols and len(rows) + len(cols) != len(members)):
            raise NotImplementedError(
                f"block {block or '<root>'!r}: {members} is neither a chain (column layers and one row layer), "
                "nor loner column layers, nor one loner row layer among whole ones")
        for n in rows + cols:
            loner[n] = not (rows and cols)
    return loner


def shard_module(module: nn.Module, rules: Optional[Sequence], tp: Optional[TPGroup]) -> Dict[str, TPSplit]:
    """Replace, in place, every layer of `module` that `rules` shards over
    "model" by this rank's split (JAX's spec on the flax view of its
    kernel or embedding), in the form its block gives it (a chain, a loner;
    see the module's docstring), and give each attention block the table
    does not split as a chain a `HeadSplit`. Returns {name in the state dict:
    its `TPSplit`} of the split tensors. With no group, or a group of one,
    nothing changes."""
    if tp is None or tp.size == 1:
        return {}
    refuse_family(module)
    sizes = {"model": tp.size}
    kinds: Dict[str, Optional[str]] = {}
    embeddings: Dict[str, int] = {}
    for name, layer in module.named_modules():
        base = "params/" + (f"{_flax_module_path(name)}/" if name else "")
        if isinstance(layer, (nn.Linear, Int8Linear)):
            spec = tuple(tp_spec(base + "kernel", (layer.in_features, layer.out_features), sizes, rules))
            if spec and spec not in _KINDS:
                raise NotImplementedError(f"{base}kernel: spec {spec} is neither column- nor row-parallel")
            kinds[name] = _KINDS.get(spec)
        elif isinstance(layer, nn.Embedding):
            path = base + _leaf(layer, "weight", 2)[0]
            spec = tuple(spec_for_param(path, tuple(layer.weight.shape), sizes, rules=rules))
            if not spec:
                continue
            if spec not in _EMBEDDING_DIMS:
                raise NotImplementedError(f"{path}: spec {spec} is neither vocab- nor hidden-parallel")
            tp_spec(path, tuple(layer.weight.shape), sizes, rules)  # the divisibility check
            embeddings[name] = _EMBEDDING_DIMS[spec]
    loner = _chains(kinds)
    dims: Dict[str, TPSplit] = {}
    replaced: Dict[str, nn.Module] = {}
    for name, kind in kinds.items():
        if kind is None:
            continue
        layer = module.get_submodule(name)
        replaced[name] = _linear_split(layer, kind, tp, loner=loner[name])
        weight = "q" if isinstance(layer, Int8Linear) else "weight"
        column = TPSplit(0, _fused_parts(layer, kind, loner[name]))
        dims[f"{name}.{weight}"] = column if kind == "column" else TPSplit(1)
        if kind == "column":
            if layer.bias is not None:
                dims[f"{name}.bias"] = column
            if isinstance(layer, Int8Linear):
                dims[f"{name}.scale"] = column
    for name, dim in embeddings.items():
        replaced[name] = _embedding_split(module.get_submodule(name), dim, tp)
        dims[f"{name}.weight"] = TPSplit(dim)
    for name, new in replaced.items():
        parent, _, child = name.rpartition(".")
        setattr(module.get_submodule(parent) if parent else module, child, new)
    for name, block in module.named_modules():
        members = [f"{name}.{n}" if name else n for n in _ATTENTION]
        if all(m in kinds for m in members) and not all(kinds[m] and not loner[m] for m in members):
            block.tp_heads = HeadSplit(tp)  # not a chain: its heads come out whole
    _head_tables(module, tp)
    return dims


def tensor_parallel_copy(module: nn.Module, rules, tp: Optional[TPGroup]) -> nn.Module:
    """A copy of `module` sharded by `shard_module` (the caller's module is
    untouched; its replicated tensors are shared, not copied). With no
    group, or a group of one, the module itself."""
    import copy

    if tp is None or tp.size == 1:
        return module
    memo = {id(t): t for t in [*module.parameters(), *module.buffers()]}
    out = copy.deepcopy(module, memo)
    shard_module(out, rules, tp)
    return out
