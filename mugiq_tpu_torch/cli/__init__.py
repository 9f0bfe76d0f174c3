"""Command-line entry points (python -m mugiq_tpu_torch.cli.loop,
python -m mugiq_tpu_torch.cli.eigensolve)."""
