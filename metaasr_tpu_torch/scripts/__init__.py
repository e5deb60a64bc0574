"""Command-line scripts of the port (counterparts of the reference's
``scripts/``), run as ``python -m metaasr_tpu_torch.scripts.<name>``.
Importing them has no side effects."""
