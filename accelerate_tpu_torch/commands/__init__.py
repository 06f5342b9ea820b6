"""The port's command line (the port of `accelerate_tpu/commands/`):
``accelerate-tpu-torch`` with `launch`, `config`, `env`, `test` and
`trace` (`accelerate_cli.py`), and ``accelerate-tpu-torch-launch``
(`launch.main`). ``python -m accelerate_tpu_torch.commands.accelerate_cli``
runs it without an install."""
