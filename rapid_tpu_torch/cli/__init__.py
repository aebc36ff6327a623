"""Command-line entry points of the port: the swarm gateway
(``python -m rapid_tpu_torch.cli.gateway``)."""
