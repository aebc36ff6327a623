"""The paper's experiment harnesses on the port, the counterparts of
``experiments/`` at the repository root, each run with
``python -m rapid_tpu_torch.experiments.<name>`` on the CUDA device unless
given ``--device cpu``:

- ``join_wave``: a wave of joiners admitted in one view change, across the
  scale axis (the bootstrap headline, paper Fig. 5);
- ``message_load``: the per-process message load of a crash under unicast
  and gossip dissemination (paper Table 2), on in-process clusters (host
  code: ``--device`` is not needed);
- ``fig11_conflict_sweep``: timing-induced proposal conflicts and their
  classic-fallback recovery (BASELINE.md's timing-conflicts table);
- ``scaling_sweep``: the warmed decision across the scale axis, through
  ``warmed_run``, the port's counterpart of ``bench.py``'s.

Each prints the JSON lines (or table rows) of its JAX counterpart."""
