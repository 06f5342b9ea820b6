"""``accelerate-tpu-torch test``: run the bundled end-to-end script (the
port of `accelerate_tpu/commands/test.py`).

It runs `test_utils/scripts/test_script.py` in a child process: on the card,
or on the CPU under ``--cpu`` (``ACCELERATE_TPU_USE_CPU=1``). With
``--num_processes N`` it first runs the script's checks across N processes:
under ``--cpu`` N gloo processes (`launchers.debug_launcher`), on the card one
process a card over NCCL (`launchers.card_launcher`, which refuses more
processes than cards). N must divide 8, the scripts' global batch, as in
JAX."""

import os
import subprocess
import sys


def register_subcommand(subparsers):
    parser = subparsers.add_parser("test", help="Run the end-to-end sanity test")
    parser.add_argument("--config_file", default=None)
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU (gloo across processes)")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="Also run the script across N coordinated processes")
    parser.set_defaults(func=test_command)
    return parser


def _script_path() -> str:
    from ..test_utils import scripts

    return os.path.join(os.path.dirname(scripts.__file__), "test_script.py")


def _script_main():
    """Module-level worker (spawn-picklable) running the bundled script."""
    import runpy

    runpy.run_path(_script_path(), run_name="__main__")


def test_command(args):
    script = _script_path()
    env = os.environ.copy()
    if args.cpu:
        env["ACCELERATE_TPU_USE_CPU"] = "1"
    # The child finds the package from a source checkout too.
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    if args.num_processes and args.num_processes > 1:
        if 8 % args.num_processes != 0:
            raise SystemExit(
                f"--num_processes must divide 8 (the test scripts' global batch "
                f"size); got {args.num_processes}. Use 2, 4, or 8."
            )
        from ..launchers import card_launcher, debug_launcher

        print(f"Running the test script across {args.num_processes} coordinated processes...")
        try:
            if args.cpu:
                debug_launcher(_script_main, num_processes=args.num_processes)
            else:
                card_launcher(_script_main, num_processes=args.num_processes)
        except (RuntimeError, ValueError) as e:
            print(str(e), file=sys.stderr)
            raise SystemExit(1) from e
        print("Multi-process run passed.")
    print("Running:  " + " ".join([sys.executable, script]))
    result = subprocess.run([sys.executable, script], env=env)
    if result.returncode == 0:
        print("Test is a success! You are ready for your distributed training!")
    else:
        raise SystemExit(result.returncode)
