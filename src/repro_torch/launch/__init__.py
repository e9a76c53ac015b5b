"""Command-line entry points of the port, with the reference's flags
(``repro.launch``): ``python -m repro_torch.launch.{train,quantize,eval,serve}``.

Each takes ``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch
path) and exposes ``main(argv=None)``, so tests and scripts can call it in
process.  Checkpoints are the reference's on-disk format, so a checkpoint
written by either package's CLI is read by the other's.
"""
