"""``accelerate-tpu-torch plan`` (the port of `accelerate_tpu/commands/plan.py`):
the cost-model planner as a command, with JAX's arguments, defaults,
choices, printed text and ``--json`` keys.

Searches the tensor-parallel decode layout for a named in-tree model (the
planner behind ``sharding_rules="auto"``, `parallel/planner.py`) and prints
the chosen plan: per-leaf specs, the emitted ``(pattern, spec)`` rules
table, predicted per-chip bytes and collective traffic per dispatch — plus
the same cost model priced over the family's hand-written table. ``--mesh
data=4,model=2`` switches to the training planner (ZeRO optimizer-state
sharding over "data" included).

Planning is shape arithmetic: the shapes come from the registry's model
built on the ``meta`` device (JAX's `eval_shape`; no weights, so a 70B
layout plans on a laptop), in f32 as JAX's tree is, and the mesh is a dict.
``--refine-top-k`` and ``--live`` build the real model (seed 0, f32) and
need the plan's mesh to fit the launched world (``accelerate-tpu-torch
launch --num_processes N``): ``--refine-top-k`` places each of the top k
plans and times a one-token forward (serving) or a fused train step
(``--mesh``); ``--live`` prepares the model under the plan on the mesh and
reports predicted against live per-rank bytes of the parameters, the
gradients and the optimizer state. A "pipeline" axis (JAX's MPMD planner)
waits for `parallel.planner.PIPELINES`. The device is the card unless
``--cpu``.
"""

import json


def register_subcommand(subparsers):
    parser = subparsers.add_parser(
        "plan", help="Search + print a sharding plan for a named model"
    )
    parser.add_argument(
        "model", nargs="?", default="llama-tiny",
        help="Named in-tree model (accelerate_tpu_torch.models registry)",
    )
    parser.add_argument("--tp", type=int, default=2, help="Tensor-parallel degree to plan for")
    parser.add_argument("--num-slots", type=int, default=8, help="Serving slots (decode batch rows)")
    parser.add_argument("--max-length", type=int, default=None, help="Per-slot cache length (default: model max)")
    parser.add_argument("--page-size", type=int, default=16, help="KV pool page size (paged cache)")
    parser.add_argument("--no-paged", action="store_true", help="Price the contiguous per-slot KV layout")
    parser.add_argument("--kv-cache-dtype", default="bf16", choices=["bf16", "int8", "fp8_e4m3"],
                        help="KV pool storage dtype the cost model prices")
    parser.add_argument("--weight-dtype", default="bf16", choices=["bf16", "int8"],
                        help="Weight storage dtype (int8 prices quantized kernels + scales)")
    parser.add_argument("--chip", default=None, help="Chip constants (parallel.planner.CHIPS key); default: by backend")
    parser.add_argument("--beam-width", type=int, default=8, help="Beam width for the strategy search")
    parser.add_argument("--refine-top-k", type=int, default=0,
                        help="Compile + time the top-k candidates and pick the measured best "
                        "(needs the plan's mesh to fit the visible devices). Serving plans "
                        "time a one-token forward; --mesh training plans time a fused "
                        "train step (grads + optimizer update included)")
    parser.add_argument("--seq-len", type=int, default=8, help="Init sequence length for shape derivation")
    parser.add_argument("--json", action="store_true", help="Machine-readable plan JSON")
    parser.add_argument(
        "--mesh", default=None,
        help='Training mesh, e.g. "data=4,model=2": switches to the training '
        "planner — params, grads AND optimizer state (ZeRO weight-update "
        "sharding along the data axis) are enumerated and priced together. "
        "A pipeline axis waits for the port's pipelines",
    )
    parser.add_argument("--batch", type=int, default=8, help="Global batch size (training planner)")
    parser.add_argument("--opt-bytes-per-param", type=float, default=8.0,
                        help="Optimizer bytes/param the cost model prices (fp32 Adam moments: 8)")
    parser.add_argument(
        "--live", action="store_true",
        help="Prepare the model under the plan on --mesh over the launched processes "
        "and report predicted-vs-live per-rank bytes of params / grads / optimizer state",
    )
    parser.add_argument("--cpu", action="store_true", help="Run --refine-top-k and --live on the CPU")
    parser.set_defaults(func=plan_command)
    return parser


def _model_shapes(name: str, materialize: bool, device=None):
    """(module, config, hand rules table) for a registry name: the family's
    module on the ``meta`` device, or with `materialize` built from seed 0
    on `device`, f32 either way."""
    import torch

    from ..models import MODEL_REGISTRY, MODULE_BY_CONFIG, create_named_model, get_model_family

    _, config = get_model_family(name)
    module_cls = MODULE_BY_CONFIG[type(config)]
    rules = list(getattr(module_cls, "sharding_rules", None) or [])
    if materialize:
        key = name.lower()
        return create_named_model(key, seed=0, dtype=torch.float32, device=device), MODEL_REGISTRY[key](), rules
    with torch.device("meta"):
        module = module_cls(config)
    return module, config, rules


def _parse_mesh(spec: str):
    """Parse ``"data=4,model=2"`` into an ordered ``{axis: size}`` dict. A bare
    axis name (no ``=``) takes the remaining process count (one only)."""
    axes = {}
    fill = None
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            name, _, size = part.partition("=")
            axes[name.strip()] = int(size)
        else:
            if fill is not None:
                raise SystemExit(f"--mesh {spec!r}: at most one axis may omit its size")
            axes[part] = -1
            fill = part
    if fill is not None:
        explicit = 1
        for name, size in axes.items():
            if size > 0:
                explicit *= size
        n = _world_size()
        if n % explicit != 0:
            raise SystemExit(
                f"--mesh {spec!r}: {n} devices not divisible by explicit sizes ({explicit})"
            )
        axes[fill] = n // explicit
    return axes


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _check_fits(mesh_axes, args):
    """This process's `PartialState` (the launcher's group, if any); JAX's
    error when the launched world is not the plan's mesh."""
    import numpy as np

    from ..state import PartialState

    state = PartialState(cpu=args.cpu)
    n_devices = int(np.prod([int(s) for s in mesh_axes.values()]))
    have = _world_size()
    if have != n_devices:
        raise SystemExit(
            f"this step needs {n_devices} devices for mesh {dict(mesh_axes)}, "
            f"have {have}"
        )
    return state


def _accelerator(args, mesh_axes):
    from ..accelerator import Accelerator
    from ..utils.dataclasses import ParallelismConfig

    return Accelerator(cpu=args.cpu, parallelism_config=ParallelismConfig(**{
        axis: int(size) for axis, size in mesh_axes.items()}))


def _train_plan_command(args, chip):
    """The ``--mesh`` branch: training planner over params+grads+opt state
    on a ("data", "model") mesh, optionally measured (``--refine-top-k``) or
    compared against LIVE placements (``--live``)."""
    from ..parallel.planner import PIPELINES, measure_train_step, plan_train_sharding, refine_plans, score_rules

    mesh_axes = _parse_mesh(args.mesh)
    if int(mesh_axes.get("pipeline", 1)) > 1:
        raise NotImplementedError(f"plan --mesh with a \"pipeline\" axis waits for {PIPELINES}")
    refine = max(0, int(args.refine_top_k))
    params, config, hand_rules = _model_shapes(args.model, materialize=False)
    plan = plan_train_sharding(
        params,
        mesh_axes,
        batch=args.batch,
        seq=args.seq_len,
        opt_bytes_per_param=args.opt_bytes_per_param,
        weight_dtype=args.weight_dtype,
        chip=chip,
        beam_width=args.beam_width,
        top_k=max(refine, 1),
    )
    measurements = None
    if refine >= 1 or args.live:
        _check_fits(mesh_axes, args)
        accelerator = _accelerator(args, mesh_axes)
        device = accelerator.device
        real, _, _ = _model_shapes(args.model, materialize=True, device="cpu")
    if refine >= 1:
        # Measured selection: place each candidate's three trees on the live
        # mesh and time a fused train step (grads + optimizer update) — the
        # training twin of the serving path's one-token forward.
        plans = plan if isinstance(plan, list) else [plan]
        per_rank = args.batch // max(1, int(mesh_axes.get("data", 1)))
        plan, measured = refine_plans(
            plans,
            lambda p: measure_train_step(
                real, accelerator.mesh, p.rules, opt_rules=p.opt_rules,
                batch=max(1, per_rank), seq=args.seq_len, device=device,
            ),
        )
        measurements = [seconds for _, seconds in measured]
    hand = (
        score_rules(
            params, mesh_axes, hand_rules,
            chip=chip, workload=plan.workload, weight_dtype=args.weight_dtype,
        )
        if hand_rules
        else None
    )
    live = _live_train_bytes(plan, mesh_axes, real, accelerator, args) if args.live else None

    if args.json:
        payload = {"model": args.model, "mesh": mesh_axes, "plan": plan.to_json()}
        if hand is not None:
            payload["hand_rules"] = {
                "rules": [[p, list(s)] for p, s in hand.rules],
                "predicted": hand.to_json()["predicted"],
                "modeled_cost": hand.cost.total,
            }
            payload["plan"]["modeled_cost"] = plan.cost.total
            payload["auto_beats_hand"] = plan.cost.total <= hand.cost.total
        if measurements is not None:
            payload["refine_measurements_s"] = measurements
        if live is not None:
            payload["live"] = live
        print(json.dumps(payload, indent=2))
        return payload

    print(f"[plan] {args.model} | mesh={mesh_axes} | batch={args.batch} | "
          f"training (opt {args.opt_bytes_per_param} B/param) weights={args.weight_dtype}")
    print()
    print(plan.describe())
    if measurements is not None:
        print()
        print(f"measure-and-refine (top-{len(measurements)}, fused train step):")
        for i, seconds in enumerate(measurements):
            print(f"  candidate {i}: {seconds * 1e6:.1f} us")
    if hand is not None:
        print()
        verdict = "matches or beats" if plan.cost.total <= hand.cost.total else "LOSES TO"
        print(
            f"hand-written family table: modeled cost {hand.cost.total:.3e} "
            f"(per-chip {int(hand.cost.per_chip_total_bytes)} bytes, "
            f"ici {int(hand.cost.collective_bytes)} B/dispatch) — "
            f"auto plan ({plan.cost.total:.3e}) {verdict} it"
        )
    if live is not None:
        print()
        print("predicted vs live per-chip bytes (this rank's tensors):")
        for tree in ("params", "grads", "opt_state"):
            row = live[tree]
            print(
                f"  {tree:<10} predicted {row['predicted_bytes']:>12}  "
                f"live {row['live_bytes']:>12}  error {row['error_pct']:.2f}%"
            )
    return plan


def _bytes_row(predicted, live):
    predicted, live = float(predicted), float(live)
    err = abs(predicted - live) / live * 100.0 if live else 0.0
    return {
        "predicted_bytes": int(predicted),
        "live_bytes": int(live),
        "error_pct": err,
    }


def _live_train_bytes(plan, mesh_axes, real, accelerator, args):
    """Prepare `real` under the plan's two tables on the launched mesh (the
    seams `prepare` uses), take one backward and one AdamW step on a batch
    of zeros (torch's AdamW makes its moments at the first step), and
    measure this rank's parameters, gradients (before the step's
    reduction, at the parameters' placement) and optimizer state. The
    prediction prices the moments alone: the step counts are a few bytes
    the byte model rounds away."""
    import torch

    from ..modeling import Model

    bundle = Model(real, loss_fn=real.loss_fn, sharding_rules=plan.rules,
                   opt_sharding_rules=list(plan.opt_rules) or None)
    optimizer = torch.optim.AdamW(real.parameters(), lr=1e-3, weight_decay=0.0)
    model, optimizer = accelerator.prepare(bundle, optimizer)
    rows = max(1, args.batch // max(1, int(mesh_axes.get("data", 1))))
    batch = {"input_ids": torch.zeros((rows, args.seq_len), dtype=torch.long, device=accelerator.device)}
    accelerator.backward(model.loss, batch)
    grads = sum(p.grad.numel() * p.grad.element_size() for p in model.module.parameters() if p.grad is not None)
    optimizer.step()
    moments = sum(t.numel() * t.element_size() for state in optimizer.optimizer.state.values()
                  for t in state.values() if torch.is_tensor(t))
    params = sum(p.numel() * p.element_size() for p in model.module.parameters())
    return {
        "params": _bytes_row(plan.cost.per_chip_param_bytes, params),
        # Grads carry the parameter dtype and placement, so the param account
        # predicts them too.
        "grads": _bytes_row(plan.cost.per_chip_param_bytes, grads),
        "opt_state": _bytes_row(plan.cost.per_chip_opt_bytes, moments),
    }


def plan_command(args):
    from ..parallel.planner import (
        CHIPS,
        measure_forward_step,
        plan_serving_sharding,
        refine_plans,
        score_rules,
    )

    chip = CHIPS[args.chip] if args.chip else None
    if args.mesh:
        return _train_plan_command(args, chip)
    refine = max(0, int(args.refine_top_k))
    params, config, hand_rules = _model_shapes(args.model, materialize=False)
    max_length = int(args.max_length or config.max_position_embeddings)
    paged = not args.no_paged
    if paged:
        pages_per_slot = -(-max_length // args.page_size)
        padded_length = pages_per_slot * args.page_size
        num_pages = args.num_slots * pages_per_slot + 1
    else:
        padded_length = max_length
        num_pages = 0

    mesh = {"model": int(args.tp)}
    plan_kwargs = dict(
        num_slots=args.num_slots,
        padded_length=padded_length,
        paged=paged,
        page_size=args.page_size,
        num_pages=num_pages,
        kv_cache_dtype=args.kv_cache_dtype,
        weight_dtype=args.weight_dtype,
        chip=chip,
        beam_width=args.beam_width,
    )
    measurements = None
    if refine >= 1:
        # Measured selection needs the launched ranks: the serving engine's
        # "model" group over them, and a one-token forward timed per
        # candidate (refine-top-k 1 still measures the single chosen plan).
        from ..parallel.sharding import serving_tp_mesh
        from ..serving import _tp_process_group

        device = _check_fits(mesh, args).device
        tp = _tp_process_group(serving_tp_mesh(args.tp)) if args.tp > 1 else None
        real, _, _ = _model_shapes(args.model, materialize=True, device="cpu")
        plans = plan_serving_sharding(params, mesh, config, top_k=refine, **plan_kwargs)
        if not isinstance(plans, list):
            plans = [plans]
        plan, measured = refine_plans(
            plans,
            lambda p: measure_forward_step(real, tp, p.rules, batch=1, device=device),
        )
        measurements = [(i, seconds) for i, (_, seconds) in enumerate(measured)]
    else:
        plan = plan_serving_sharding(params, mesh, config, **plan_kwargs)

    hand = (
        score_rules(
            params, mesh, hand_rules,
            chip=chip, workload=plan.workload, weight_dtype=args.weight_dtype,
        )
        if hand_rules
        else None
    )

    if args.json:
        payload = {"model": args.model, "plan": plan.to_json()}
        if hand is not None:
            payload["hand_rules"] = {
                "rules": [[p, list(s)] for p, s in hand.rules],
                "predicted": hand.to_json()["predicted"],
                "modeled_cost": hand.cost.total,
            }
            payload["plan"]["modeled_cost"] = plan.cost.total
            payload["auto_beats_hand"] = plan.cost.total <= hand.cost.total
        if measurements is not None:
            payload["refine_measurements_s"] = [s for _, s in measurements]
        print(json.dumps(payload, indent=2))
        return payload

    print(f"[plan] {args.model} | tp={args.tp} | slots={args.num_slots} | "
          f"{'paged' if paged else 'contiguous'} kv={args.kv_cache_dtype} "
          f"weights={args.weight_dtype}")
    print()
    print(plan.describe())
    if measurements is not None:
        print()
        print("measure-and-refine (top-{}):".format(len(measurements)))
        for i, seconds in measurements:
            print(f"  candidate {i}: {seconds * 1e6:.1f} us")
    if hand is not None:
        print()
        verdict = "matches or beats" if plan.cost.total <= hand.cost.total else "LOSES TO"
        print(
            f"hand-written family table: modeled cost {hand.cost.total:.3e} "
            f"(per-chip {int(hand.cost.per_chip_total_bytes)} bytes, "
            f"ici {int(hand.cost.collective_bytes)} B/dispatch) — "
            f"auto plan ({plan.cost.total:.3e}) {verdict} it"
        )
    return plan
