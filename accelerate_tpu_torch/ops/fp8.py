"""fp8 matmuls for training: the port of `accelerate_tpu/ops/fp8.py`.

A linear layer's product runs on per-tensor scaled fp8 operands with f32
accumulation: ``x @ w`` as ``(xq @ wq) * (sx * sw)``, rounded once to x's
dtype. The forward casts x and w to e4m3; the backward casts the incoming
gradient to e5m2 under the HYBRID format (the default, TransformerEngine's)
and to e4m3 under E4M3, and takes dx and dw from the saved fp8 x and w.

Scaling is dynamic by default: each tensor's scale is its own amax over the
format's largest value, computed on the device (no host read). The delayed
recipe (`FP8RecipeKwargs(scaling="delayed")`) takes the forward scales from
a rolling window of amaxes instead: `fp8_matmul_delayed` threads the
histories explicitly, and its gradient with respect to them is the rolled
history, as in the JAX package.

The product itself is no TPU kernel (JAX leaves it to XLA's `dot_general`):
on CUDA tensors it is `torch._scaled_mm` (fp8 tensor cores; its second
operand column-major, every dimension a multiple of 16, e5m2 x e5m2 not
taken: a shape or pair it refuses raises, nothing falls back); on CPU
tensors its plain version, ``(qa.float() @ qb.float()) * (sa * sb)``, the
f32 product of the fp8 values that XLA's CPU lowering computes.

`fp8_autocast(recipe)` runs every linear layer called inside it through the
fp8 path: every `nn.Linear`, the port's counterpart of flax's ``nn.Dense``
(the models' `Dense` included), whose product the JAX package's interceptor
takes over; no other product. It pushes, for the duration of each such
layer's forward only, a function mode that takes over the layer's one
`F.linear`, and computes it from the layer's own input and parameters
(`fp8_dense_apply`), bias added after in the output dtype. The recipe is
per thread: `ops.remat.maybe_remat` captures it at the forward and enters it
again around its recompute, which the autograd engine may run on another
thread. Under the delayed recipe each layer keeps its forward histories in
``module.fp8_meta``, rolled only inside ``fp8_autocast(recipe,
update_meta=True)`` (flax's ``mutable=["fp8_meta"]``).

Across processes every amax that JAX takes over the batch-sharded
activations is the amax over the global batch: GSPMD reduces JAX's
``jnp.max(jnp.abs(x))`` across the devices, and the port all-reduces (max)
each process's amax over the recipe's `group`, which `PreparedModel` fills
with the process group of its ("data", "fsdp") mesh. That covers the
forward's x amax, the backward's g amax and, under the delayed recipe, the
observed x and g amaxes rolled into the histories, so the scales and the
histories are the same on every process. The weight's amax needs no
collective: every strategy's forward sees the whole weight (replicated
under NO_SHARD and SHARD_GRAD_OP, all-gathered by torch's FSDP under
FULL_SHARD). A recompute (`maybe_remat`) runs the forward again and
reduces again, as JAX's recompute does, on the same inputs, so it gets the
forward's scale; every process issues the reductions in the same order.
Without a group nothing is reduced.

`PRODUCTS` counts the fp8 products run since the last reset, by role: the
forward's ``fwd`` and the backward's ``dx`` and ``dw``; `AMAX_REDUCES`
counts the amax all-reduces issued (``all_reduce``). While a profiler
records, the quantize passes (amax, scale, cast) run inside a
``fp8_quantize`` range and the operand copies `_scaled_mm`'s layout needs
inside ``fp8_layout``; otherwise no range is opened.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.autograd import profiler
from torch.overrides import TorchFunctionMode

E4M3 = torch.float8_e4m3fn
E5M2 = torch.float8_e5m2
E4M3_MAX = 448.0
E5M2_MAX = 57344.0

#: fp8 products since the last reset, by role.
PRODUCTS: Dict[str, int] = {"fwd": 0, "dx": 0, "dw": 0}
#: amax all-reduces over a recipe's process group since the last reset.
AMAX_REDUCES: Dict[str, int] = {"all_reduce": 0}


def reset_product_counts():
    for counts in (PRODUCTS, AMAX_REDUCES):
        for key in counts:
            counts[key] = 0


def _span(name: str):
    return torch.profiler.record_function(name) if profiler._is_profiler_enabled else contextlib.nullcontext()


def _fmax(dtype) -> float:
    return E4M3_MAX if dtype == E4M3 else E5M2_MAX


def _amax(x, group=None):
    """x's amax in f32; with a process group, the amax over every process's
    x (one all-reduce, max)."""
    amax = x.detach().abs().amax().float()
    if group is not None:
        AMAX_REDUCES["all_reduce"] += 1
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    return amax


def quantize_fp8(x, dtype=E4M3, group=None):
    """Per-tensor dynamic scaling: returns (x_fp8, scale) with x ≈ x_fp8 * scale.
    With a process `group` the scale is the one of the processes' x together."""
    with _span("fp8_quantize"):
        scale = _amax(x, group).clamp_min(1e-12) / _fmax(dtype)
        return (x.float() / scale).to(dtype), scale


def _fp8_dot(a, a_scale, b, b_scale, out_dtype, role: str):
    """``(a @ b) * (a_scale * b_scale)`` of 2-D fp8 operands, summed in f32
    and rounded once to `out_dtype`."""
    PRODUCTS[role] += 1
    if a.is_cuda:
        # _scaled_mm takes a row-major first and a column-major second
        # operand; `contiguous` copies only an operand in the other layout.
        with _span("fp8_layout"):
            a, b = a.contiguous(), b.t().contiguous().t()
        return torch._scaled_mm(a, b, scale_a=a_scale, scale_b=b_scale, out_dtype=out_dtype)
    return ((a.float() @ b.float()) * (a_scale * b_scale)).to(out_dtype)


def _forward_product(xq, sx, wq, sw, dtype):
    """``x @ w`` over x's leading dims."""
    out = _fp8_dot(xq.reshape(-1, xq.shape[-1]), sx, wq, sw, dtype, "fwd")
    return out.reshape(*xq.shape[:-1], wq.shape[-1])


def _backward_products(ctx, xq, sx, wq, sw, gq, sg, dtype):
    """(dx, dw) of ``x @ w``: ``g @ w.T`` and ``x.T @ g``, the latter taken as
    ``(g.T @ x).T`` so that the weight's gradient comes back row-major.
    Each is None where its input needs none."""
    g2 = gq.reshape(-1, gq.shape[-1])
    dx = dw = None
    if ctx.needs_input_grad[0]:
        dx = _fp8_dot(g2, sg, wq.T, sw, dtype, "dx").reshape(xq.shape)
    if ctx.needs_input_grad[1]:
        dw = _fp8_dot(g2.T, sg, xq.reshape(-1, xq.shape[-1]), sx, dtype, "dw").T
    return dx, dw


def _grad_dtype(hybrid: bool):
    return E5M2 if hybrid else E4M3


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, hybrid, group):
        xq, sx = quantize_fp8(x, E4M3, group)
        wq, sw = quantize_fp8(w, E4M3)
        ctx.save_for_backward(xq, sx, wq, sw)
        ctx.hybrid, ctx.group = hybrid, group
        return _forward_product(xq, sx, wq, sw, x.dtype)

    @staticmethod
    def backward(ctx, g):
        xq, sx, wq, sw = ctx.saved_tensors
        gq, sg = quantize_fp8(g, _grad_dtype(ctx.hybrid), ctx.group)
        return (*_backward_products(ctx, xq, sx, wq, sw, gq, sg, g.dtype), None, None)


def fp8_matmul(x, w, hybrid: bool = True, group=None):
    """`x @ w` with fp8 operands and fp32 accumulation.

    x: [..., K], w: [K, N]. Forward casts both to e4m3; backward casts the
    cotangent to e5m2 when `hybrid` (TE HYBRID recipe) else e4m3. With a
    process `group`, x and the cotangent are scaled by their amax over
    every process's rows (w is whole on each process).
    """
    return _Fp8Matmul.apply(x, w, hybrid, group)


# ------------------------------------------------------------- delayed scaling


def init_fp8_meta(history_len: int = 16, device=None):
    """Fresh (cold) delayed-scaling state for ONE matmul: zeros mean "no amax
    observed", which `_history_scale` maps to scale 1.0 until real amaxes
    roll in."""
    return {key: torch.zeros(int(history_len), dtype=torch.float32, device=device)
            for key in ("x_amax_history", "w_amax_history", "g_amax_history")}


def _history_scale(history, fmax, algo: str = "max"):
    """'max' covers the whole window, 'most_recent' the last step only."""
    amax = history[-1] if algo == "most_recent" else history.max()
    return torch.where(amax > 0.0, amax.clamp_min(1e-12) / fmax, torch.ones_like(amax))


def _roll_amax(history, amax):
    return torch.cat([history[1:], amax.reshape(1).float()])


def _quantize_with_scale(x, scale, dtype):
    """Cast with an external (history) scale, clipped to the format's range
    first: the scale may under-estimate the current tensor."""
    fmax = _fmax(dtype)
    with _span("fp8_quantize"):
        return torch.clamp(x.float() / scale, -fmax, fmax).to(dtype)


class _Fp8Delayed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, hx, hw, hg, hybrid, algo, group):
        sx = _history_scale(hx, E4M3_MAX, algo)
        sw = _history_scale(hw, E4M3_MAX, algo)
        xq = _quantize_with_scale(x, sx, E4M3)
        wq = _quantize_with_scale(w, sw, E4M3)
        ctx.save_for_backward(xq, sx, wq, sw, hx, hw, hg, _amax(x, group), _amax(w))
        ctx.hybrid, ctx.algo, ctx.group = hybrid, algo, group
        return _forward_product(xq, sx, wq, sw, x.dtype)

    @staticmethod
    def backward(ctx, g):
        xq, sx, wq, sw, hx, hw, hg, amax_x, amax_w = ctx.saved_tensors
        gdtype = _grad_dtype(ctx.hybrid)
        sg = _history_scale(hg, _fmax(gdtype), ctx.algo)
        gq = _quantize_with_scale(g, sg, gdtype)
        dx, dw = _backward_products(ctx, xq, sx, wq, sw, gq, sg, g.dtype)
        return (dx, dw, _roll_amax(hx, amax_x), _roll_amax(hw, amax_w), _roll_amax(hg, _amax(g, ctx.group)),
                None, None, None)


def fp8_matmul_delayed(x, w, meta, hybrid: bool = True, amax_algo: str = "max", group=None):
    """`x @ w` in fp8 under the DELAYED recipe: forward scales from
    ``meta['x_amax_history']`` / ``['w_amax_history']``, the backward's
    gradient scale from ``meta['g_amax_history']``. The gradient with
    respect to each history IS its update (rolled with this step's observed
    amax)::

        meta = {k: v.requires_grad_() for k, v in meta.items()}
        grads = torch.autograd.grad(loss, [x, w, *meta.values()])
        # the next step uses dict(zip(meta, grads[2:]))

    x: [..., K], w: [K, N]. With a process `group` the observed x and g
    amaxes are the global ones, so the histories stay equal on every process.
    """
    return _Fp8Delayed.apply(x, w, meta["x_amax_history"], meta["w_amax_history"], meta["g_amax_history"],
                             hybrid, amax_algo, group)


class _Fp8Scaled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, sx, sw, hybrid, group):
        xq = _quantize_with_scale(x, sx, E4M3)
        wq = _quantize_with_scale(w, sw, E4M3)
        ctx.save_for_backward(xq, sx, wq, sw)
        ctx.hybrid, ctx.group = hybrid, group
        return _forward_product(xq, sx, wq, sw, x.dtype)

    @staticmethod
    def backward(ctx, g):
        xq, sx, wq, sw = ctx.saved_tensors
        gq, sg = quantize_fp8(g, _grad_dtype(ctx.hybrid), ctx.group)
        return (*_backward_products(ctx, xq, sx, wq, sw, gq, sg, g.dtype), None, None, None, None)


def _fp8_matmul_fwd_scaled(x, w, sx, sw, hybrid: bool = True, group=None):
    """Forward with external scales, backward with dynamic gradient scaling:
    the autocast's delayed mode (the layer owns its forward histories; the
    gradient's has no channel back to it)."""
    return _Fp8Scaled.apply(x, w, sx, sw, hybrid, group)


# ------------------------------------------------------------- the autocast


@dataclasses.dataclass(frozen=True)
class Fp8Recipe:
    """What `fp8_autocast` runs under: the fields of `FP8RecipeKwargs` it
    reads, whether delayed histories roll (`update_meta`), the process group
    whose amaxes are reduced together (`group`: None with one process), and,
    for a recompute, each layer's histories as its forward read them
    (`metas`)."""

    hybrid: bool = True
    scaling: str = "dynamic"
    history_len: int = 16
    amax_algo: str = "max"
    update_meta: bool = False
    metas: Optional[dict] = None
    group: Optional[object] = None

    @classmethod
    def of(cls, fp8_recipe=None, update_meta: bool = False, group=None) -> "Fp8Recipe":
        if fp8_recipe is None:
            return cls(update_meta=update_meta, group=group)
        return cls(
            hybrid=getattr(fp8_recipe, "fp8_format", "HYBRID") != "E4M3",
            scaling=getattr(fp8_recipe, "scaling", "dynamic"),
            history_len=int(getattr(fp8_recipe, "amax_history_len", 16) or 16),
            amax_algo=getattr(fp8_recipe, "amax_compute_algo", "max"),
            update_meta=update_meta,
            group=group,
        )


_DEFAULT = Fp8Recipe()
_LOCAL = threading.local()


def _stack(name: str) -> list:
    if not hasattr(_LOCAL, name):
        setattr(_LOCAL, name, [])
    return getattr(_LOCAL, name)


def active_recipe() -> Optional[Fp8Recipe]:
    """The recipe of this thread's innermost `fp8_autocast`, or None."""
    recipes = _stack("recipes")
    return recipes[-1] if recipes else None


def fp8_dense_apply(module: nn.Linear, x):
    """Compute a linear layer with the fp8 path, reusing its own parameters:
    JAX's ``x @ kernel`` with ``kernel = weight.T`` cast to x's dtype."""
    recipe = active_recipe() or _DEFAULT
    w = module.weight.T.to(x.dtype)
    if recipe.scaling == "delayed":
        y = _fp8_dense_apply_delayed(module, x, w, recipe)
    else:
        y = fp8_matmul(x, w, recipe.hybrid, recipe.group)
    if module.bias is not None:
        y = y + module.bias.to(y.dtype)
    return y


def _fp8_dense_apply_delayed(module, x, w, recipe: Fp8Recipe):
    """The autocast's delayed mode: the layer's forward amax histories live
    in ``module.fp8_meta`` (cold, scale 1.0, until a first update), roll
    when the recipe says `update_meta`, and are read as they are
    otherwise, e.g. at eval."""
    meta = recipe.metas.get(module) if recipe.metas is not None else getattr(module, "fp8_meta", None)
    if meta is None:
        cold = torch.zeros(recipe.history_len, dtype=torch.float32, device=x.device)
        meta = {"x_amax_history": cold, "w_amax_history": cold}
    hx, hw = meta["x_amax_history"], meta["w_amax_history"]
    sx = _history_scale(hx, E4M3_MAX, recipe.amax_algo)
    sw = _history_scale(hw, E4M3_MAX, recipe.amax_algo)
    y = _fp8_matmul_fwd_scaled(x, w, sx, sw, recipe.hybrid, recipe.group)
    if recipe.update_meta:
        module.fp8_meta = {"x_amax_history": _roll_amax(hx, _amax(x, recipe.group)),
                           "w_amax_history": _roll_amax(hw, _amax(w))}
    return y


class _LinearMode(TorchFunctionMode):
    """Active inside one linear layer's forward: the layer's `F.linear`
    becomes `fp8_dense_apply` on the input the layer was called with."""

    def __init__(self, module, x):
        super().__init__()
        self.module, self.x = module, x

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is F.linear and self.x is not None:
            x, self.x = self.x, None
            return fp8_dense_apply(self.module, x)
        return func(*args, **(kwargs or {}))


def _intercepted(module) -> bool:
    return active_recipe() is not None and isinstance(module, nn.Linear) and not isinstance(module, Fp8Linear)


def _pre_hook(module, args):
    if _intercepted(module) and args:
        mode = _LinearMode(module, args[0])
        mode.__enter__()
        _stack("modes").append(mode)


def _post_hook(module, args, output):
    modes = _stack("modes")
    if modes and modes[-1].module is module:
        modes.pop().__exit__(None, None, None)


_HOOKS: Dict[str, object] = {"users": 0, "handles": ()}
_HOOKS_LOCK = threading.Lock()


def _hold_hooks(delta: int):
    """Register the global module hooks while any thread is inside an
    autocast; remove them when the last one leaves."""
    with _HOOKS_LOCK:
        _HOOKS["users"] += delta
        if _HOOKS["users"] == 1 and not _HOOKS["handles"]:
            _HOOKS["handles"] = (
                nn.modules.module.register_module_forward_pre_hook(_pre_hook),
                nn.modules.module.register_module_forward_hook(_post_hook, always_call=True),
            )
        elif _HOOKS["users"] == 0:
            for handle in _HOOKS["handles"]:
                handle.remove()
            _HOOKS["handles"] = ()


@contextlib.contextmanager
def recipe_scope(recipe: Optional[Fp8Recipe]):
    """Run linear layers under `recipe` in this thread (None: as they are)."""
    if recipe is None:
        yield
        return
    recipes = _stack("recipes")
    recipes.append(recipe)
    _hold_hooks(+1)
    try:
        yield
    finally:
        recipes.pop()
        _hold_hooks(-1)


def fp8_autocast(fp8_recipe=None, update_meta: bool = False, group=None):
    """Run every linear layer (`nn.Linear`) called inside this context through
    the fp8 path, under `fp8_recipe` (an `FP8RecipeKwargs`; None: dynamic
    scaling, HYBRID). With ``scaling="delayed"`` the forward scales come from
    each layer's own histories, which roll with this call's amaxes when
    `update_meta` is set (JAX's ``apply(..., mutable=["fp8_meta"])``). With a
    process `group` every activation and gradient amax is the one over the
    group's processes (each process holding its rows of the global batch)."""
    return recipe_scope(Fp8Recipe.of(fp8_recipe, update_meta, group))


def recompute_recipe(layer: nn.Module) -> Optional[Fp8Recipe]:
    """The active recipe as a recompute of `layer` must see it: no history
    updates, and under the delayed recipe each linear layer's histories as
    they are now, before the forward rolls them. None outside an autocast."""
    recipe = active_recipe()
    if recipe is None:
        return None
    metas = None
    if recipe.scaling == "delayed":
        metas = {m: getattr(m, "fp8_meta", None) for m in layer.modules() if isinstance(m, nn.Linear)}
    return dataclasses.replace(recipe, update_meta=False, metas=metas)


class Fp8Linear(nn.Linear):
    """A linear layer that always runs fp8 (the port of `Fp8Dense`, for model
    authors who want fp8 outside the autocast): dynamic scaling, the
    gradient in e5m2 unless the active recipe is E4M3, bias added after in
    the output dtype."""

    def forward(self, x):
        recipe = active_recipe() or _DEFAULT
        y = fp8_matmul(x, self.weight.T.to(x.dtype), recipe.hybrid, recipe.group)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y
