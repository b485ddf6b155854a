"""PyTorch/CUDA port of ``alphazero_tpu`` for one NVIDIA H100.

The package mirrors the JAX package's module layout (``core``, ``games``,
``ops``, ``models``, ``mcts``, ``selfplay``, ``training``, ``eval``,
``elo``, ``scripts``, ``utils`` and the top-level ``facade``, ``cli``,
``api_server`` and ``webui``) so each module has an obvious counterpart, and imports ``torch`` only: nothing of JAX, flax or
``alphazero_tpu``.  Hand-written CUDA kernels live in ``csrc/`` and are built
with ``nvcc`` at first use (``ops/_build.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on a
CPU tensor every kernel wrapper takes its plain PyTorch version.
"""

__version__ = "0.1.0"  # the JAX package's, reported by the REST API
