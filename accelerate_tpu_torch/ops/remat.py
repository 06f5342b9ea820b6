"""Per-layer activation checkpointing: the port of `accelerate_tpu/ops/remat.py`.

The backward pass recomputes one layer's internals at a time, so the forward
keeps only each layer's inputs (and, under a selective policy, the outputs
of its matmuls) instead of every intermediate.

As in the JAX package the seam is a scope, not a rewrapped model: a
`remat_scope(policy)` sets a context variable, and every in-tree model calls
its layers through `maybe_remat(layer, *args)` at its layer loop. That is the
plain call unless a scope is active and autograd is recording; then it is
`torch.utils.checkpoint.checkpoint` (non-reentrant) over the layer, with the
policy's selective-checkpoint context. `PreparedModel` enters the scope
around its forward when `CompilationConfig.remat_policy` asks for it, so the
knob acts on any in-tree model with no per-model setting. Serving and
`generate` run under `torch.no_grad()` and never checkpoint.

Policies, with the meaning of JAX's `jax.checkpoint_policies`:

  - ``full``, ``nothing_saveable``: save nothing inside the layer;
  - ``dots``, ``dots_saveable``: save the outputs of the matmuls
    (``aten.mm``, ``addmm``, ``bmm``, ``baddbmm``, and fp8's ``_scaled_mm``:
    JAX's ``dot_general``) and recompute the elementwise chain;
  - ``dots_with_no_batch_dims``: save ``mm``/``addmm``/``_scaled_mm`` only,
    not the batched score products.

A flash kernel's output is never saved: its launch is no aten op (JAX's
``pallas_call`` is no ``dot_general``), so the recompute launches the
forward kernel again, and the backward kernels run on its fresh o and lse.

Under `ops.fp8.fp8_autocast` the recompute runs under the recipe the
forward ran under, captured at the call: the autograd engine runs the
backward (and so the recompute) on a thread of its own on the card, where
the forward's context is not set. JAX's `jax.checkpoint` retraces inside
its interceptor in the same way.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Optional

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from .fp8 import recipe_scope, recompute_recipe

# Active remat policy name, or None (no remat), read at forward time.
_REMAT_POLICY: contextvars.ContextVar = contextvars.ContextVar("remat_policy", default=None)

#: CompilationConfig.remat_policy values (JAX's names).
POLICY_NAMES = ("full", "nothing_saveable", "dots", "dots_saveable", "dots_with_no_batch_dims")

_MATMULS = ("mm", "addmm", "bmm", "baddbmm", "_scaled_mm")


def _saved_ops(name: str):
    """The aten overload packets whose outputs `name` saves (None: none)."""
    aten = torch.ops.aten
    return {
        "full": None,
        "nothing_saveable": None,
        "dots": tuple(getattr(aten, op) for op in _MATMULS),
        "dots_saveable": tuple(getattr(aten, op) for op in _MATMULS),
        "dots_with_no_batch_dims": (aten.mm, aten.addmm, aten._scaled_mm),
    }[name]


def _policy_fn(saved, ctx, op, *args, **kwargs):
    packet = getattr(op, "overloadpacket", op)
    return CheckpointPolicy.MUST_SAVE if packet in saved else CheckpointPolicy.PREFER_RECOMPUTE


def _context_fn(name: str):
    """`checkpoint`'s ``context_fn`` for `name`."""
    saved = _saved_ops(name)
    if saved is None:
        return noop_context_fn
    return functools.partial(create_selective_checkpoint_contexts, functools.partial(_policy_fn, saved))


def check_policy(policy: Optional[str]) -> Optional[str]:
    """`policy`, if it is None or one of POLICY_NAMES; else JAX's ValueError."""
    if policy is not None and policy not in POLICY_NAMES:
        raise ValueError(f"remat policy must be one of {POLICY_NAMES}, got {policy!r}")
    return policy


@contextlib.contextmanager
def remat_scope(policy: Optional[str] = "full"):
    """Checkpoint every in-tree layer called inside this scope.

    `policy` is one of POLICY_NAMES (None disables, for callers threading a
    config value straight through)."""
    token = _REMAT_POLICY.set(check_policy(policy))
    try:
        yield
    finally:
        _REMAT_POLICY.reset(token)


def active_remat_policy() -> Optional[str]:
    return _REMAT_POLICY.get()


def maybe_remat(layer: torch.nn.Module, *args, **kwargs):
    """``layer(*args, **kwargs)``, checkpointed under the active scope.

    The layer loop of every in-tree model calls this instead of the layer.
    The recompute runs in the backward, after the forward's caller may have
    swapped the module's tensors back (`PreparedModel` runs the forward on
    compute-dtype copies through `torch.func.functional_call`), so the
    layer's parameters and buffers are taken now and passed to the
    recompute explicitly: it sees the tensors the forward saw, and the fp8
    recipe the forward ran under. Parameters FSDP manages (`DTensor`s
    until its hook gathers them at the call) are left to FSDP, which
    gathers them again for the recompute."""
    name = _REMAT_POLICY.get()
    if name is None or not torch.is_grad_enabled():
        return layer(*args, **kwargs)
    tensors = {n: t for n, t in (*layer.named_parameters(), *layer.named_buffers()) if not isinstance(t, DTensor)}
    fp8 = recompute_recipe(layer)
    calls = []

    def run(*a, **kw):
        # The first call is the forward, inside the caller's own context;
        # every later one a recompute.
        with recipe_scope(fp8 if calls else None):
            calls.append(1)
            return torch.func.functional_call(layer, tensors, a, kw)

    return checkpoint(run, *args, use_reentrant=False, context_fn=_context_fn(name), **kwargs)
