"""Terminal play against the port's engine (counterparts of
``examples/play_{gomoku,go,chess}.py``), on ``cli.GameSession``:

    python -m alphazero_tpu_torch.examples.play_gomoku [--board-size 9]
    python -m alphazero_tpu_torch.examples.play_go [--board-size 9]
    python -m alphazero_tpu_torch.examples.play_chess [--chess960 N]

Each takes the JAX example's flags and ``--device`` (default ``cuda``).
Besides moves, each reads ``new`` (a new game) and ``quit``; the end of
the input ends the session as ``quit`` does, so a piped game exits 0.
"""
