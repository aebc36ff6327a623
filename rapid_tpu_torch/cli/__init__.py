"""Command-line entry points of the port: the swarm gateway
(``python -m rapid_tpu_torch.cli.gateway``), the standalone agent
(``python -m rapid_tpu_torch.cli.agent``), a multi-process mesh rank
(``python -m rapid_tpu_torch.cli.multihost_sim``), the nemesis search
(``python -m rapid_tpu_torch.cli.hunt``, ``tools/hunt.py``'s counterpart),
the forensics timeline (``python -m rapid_tpu_torch.cli.forensics``,
``tools/forensics.py``'s counterpart), the scenario battery (``python -m
rapid_tpu_torch.cli.scenarios``, ``scenarios.py``'s counterpart), the
merge gate (``python -m rapid_tpu_torch.cli.check --all``: ``check``,
``concur`` and ``devlint`` over ``lintlib``), and the operator's
``perfscope``, ``tracecat`` and ``coverage``, each the counterpart of its
namesake in ``tools/``."""
