"""``accelerate-tpu-torch``: the subcommand dispatcher (the port of
`accelerate_tpu/commands/accelerate_cli.py`). It registers the subcommands
the port has: `config`, `convert` (with `merge`, which raises until ROADMAP
A's order step 6), `env`, `estimate-memory`, `launch`, `plan` (but for its
"pipeline" axis, which waits for item 3's pipelines), `test` and `trace`.
JAX's others wait for their ROADMAP A items: `tpu` for item 2's GPU-host
bullet, `chaos` and `serve` for item 6, `analysis` for item 7."""

import argparse


def get_command_parser():
    parser = argparse.ArgumentParser(
        "accelerate-tpu-torch", usage="accelerate-tpu-torch <command> [<args>]", allow_abbrev=False
    )
    subparsers = parser.add_subparsers(help="accelerate-tpu-torch command helpers", dest="command")
    from . import config, convert, env, estimate, launch, plan, test, trace

    config.register_subcommand(subparsers)
    convert.register_subcommand(subparsers)
    env.register_subcommand(subparsers)
    estimate.register_subcommand(subparsers)
    launch.register_subcommand(subparsers)
    plan.register_subcommand(subparsers)
    test.register_subcommand(subparsers)
    trace.register_subcommand(subparsers)
    return parser


def main(argv=None):
    """Dispatch `argv` (the command line's arguments by default)."""
    parser = get_command_parser()
    args = parser.parse_args(argv)
    if not hasattr(args, "func"):
        parser.print_help()
        raise SystemExit(1)
    args.func(args)


if __name__ == "__main__":
    main()
