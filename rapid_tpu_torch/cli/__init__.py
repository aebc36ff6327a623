"""Command-line entry points of the port: the swarm gateway
(``python -m rapid_tpu_torch.cli.gateway``), the standalone agent
(``python -m rapid_tpu_torch.cli.agent``) and a multi-process mesh rank
(``python -m rapid_tpu_torch.cli.multihost_sim``)."""
