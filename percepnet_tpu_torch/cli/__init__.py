"""Command-line entry points, dispatched by `python -m percepnet_tpu_torch
<command>`.  Each takes --device: the card by default, `cpu` for a host
run; with no card and no `--device cpu` a command raises."""
