"""The repo's training, A/B and fuzz tools on the port (counterparts of the
same-named files under ``tools/``).

Each keeps the JAX tool's environment knobs, their names and their
defaults, and adds ``--device`` (default ``cuda``) and ``--output``.  The
JAX tools write into ``docs/`` and ``/tmp``; these write only where
``--output`` says (default under ``build/tools/`` of the checkout) and
refuse a path under ``docs/`` or ``models_zoo/`` (``_common.check_output``).

    python -m alphazero_tpu_torch.tools.train_zoo_go9
    python -m alphazero_tpu_torch.tools.ab_arena int8
"""
