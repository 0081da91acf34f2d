"""Command-line entry points of the port, run as ``python -m
bvsc_tpu_torch.cli.<name>``: ``codec_cli`` (``.bvsc`` files)."""
