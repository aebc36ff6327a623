"""PyTorch/CUDA port of rapid-tpu's simulation plane.

Mirrors the layout of ``rapid_tpu`` (``hashing``, ``sim.topology``,
``sim.engine``, ``sim.driver``) so each module's counterpart is found by
name; ``sim.kernels`` binds the hand-written CUDA kernels in ``csrc/``.
Imports torch and numpy only: nothing of JAX and nothing of ``rapid_tpu``.
"""
