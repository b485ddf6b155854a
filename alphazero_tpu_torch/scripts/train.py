"""Training CLI (counterpart of ``alphazero_tpu/scripts/train.py``, the same
flags plus ``--device`` and ``--inference``).

Runs the actor -> replay -> learner pipeline (``training/pipeline.py``)
with checkpoints and ``history.json`` under ``--checkpoint-dir``.

    python -m alphazero_tpu_torch.scripts.train --board-size 15 \\
        --iterations 50 --games-per-iteration 256 --simulations 800

    python -m alphazero_tpu_torch.scripts.train --config config/gomoku_15x15.json

    python -m alphazero_tpu_torch.scripts.train --game go --board-size 9 \
        --komi 7.5          # or --config config/go_9x9.json

    python -m alphazero_tpu_torch.scripts.train --game chess --board-size 8
                            # or --config config/chess.json

    python -m alphazero_tpu_torch.scripts.train --model randwire
                            # DDW-RandWire (4 blocks unless --blocks)

    python -m alphazero_tpu_torch.scripts.train --game go --board-size 19 \
        --block nbt --blocks 18 --channels 384 --inference folded
                            # KataGo's b18c384nbt trunk (no int8 executor)

Data-parallel over several processes (one card each, NCCL; gloo with
``--device cpu``): each rank plays and trains on its share of the games and
of each batch, and the gradients are averaged (``parallel/``)::

    torchrun --nproc-per-node 4 -m alphazero_tpu_torch.scripts.train \
        --config config/gomoku_15x15.json

``--model randwire`` trains ``models/randwire.DDWRandWireResNet`` with
``--blocks`` and ``--channels`` (the JAX CLI reads the flag but builds the
ResNet whatever it says).
"""
from __future__ import annotations

import argparse
import logging


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default=None,
                   help="pipeline config JSON; other flags are ignored when "
                        "set except --resume and --device")
    p.add_argument("--game", default="gomoku",
                   choices=["gomoku", "go", "chess"])
    p.add_argument("--board-size", type=int, default=15)
    p.add_argument("--iterations", type=int, default=100)
    p.add_argument("--games-per-iteration", type=int, default=256)
    p.add_argument("--simulations", type=int, default=800)
    p.add_argument("--max-moves", type=int, default=None)
    p.add_argument("--wave", type=int, default=16,
                   help="virtual-loss descents per wave sharing one NN batch")
    p.add_argument("--recycle", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="continuous self-play: finished lanes restart at once")
    p.add_argument("--train-steps", type=int, default=64)
    p.add_argument("--train-batch-size", type=int, default=1024)
    p.add_argument("--replay-capacity", type=int, default=500_000)
    p.add_argument("--min-replay", type=int, default=10_000)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--scheduler", default="warmup_cosine")
    p.add_argument("--blocks", type=int, default=None,
                   help="residual blocks (resnet, default 6) or RandWire "
                        "blocks (randwire, default 4)")
    p.add_argument("--channels", type=int, default=64)
    p.add_argument("--model", default="resnet", choices=["resnet", "randwire"])
    p.add_argument("--block", default="se", choices=["se", "nbt"],
                   help="resnet trunk: SE-ResNet blocks, or KataGo's "
                        "nested-bottleneck blocks (the two flags below)")
    p.add_argument("--gpool-channels", type=int, default=64,
                   help="nbt: global-pooling channels")
    p.add_argument("--gpool-every", type=int, default=3,
                   help="nbt: every n-th block pools (0: none)")
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--checkpoint-every", type=int, default=5)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--use-renju", action="store_true")
    p.add_argument("--use-omok", action="store_true")
    p.add_argument("--komi", type=float, default=7.5)
    p.add_argument("--games-dir", default=None,
                   help="train offline from the GameRecord JSONs in this "
                        "directory instead of generating self-play games")
    p.add_argument("--inference", default=None,
                   choices=["int8", "folded", "raw"],
                   help="actor inference path (default: production.py's)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    return p


def pipeline_config(args):
    """The ``PipelineConfig`` the flags in ``args`` describe (``--config``
    aside)."""
    from alphazero_tpu_torch import production
    from alphazero_tpu_torch.mcts.search import MCTSConfig
    from alphazero_tpu_torch.models.resnet import ResNetConfig
    from alphazero_tpu_torch.selfplay.actor import SelfPlayConfig
    from alphazero_tpu_torch.training.learner import LearnerConfig
    from alphazero_tpu_torch.training.pipeline import PipelineConfig

    game_options = []
    if args.game == "gomoku":
        if args.use_renju:
            game_options.append(("use_renju", True))
        if args.use_omok:
            game_options.append(("use_omok", True))
        max_moves = args.max_moves or args.board_size ** 2 + 1
    elif args.game == "go":
        game_options.append(("komi", args.komi))
        max_moves = args.max_moves or 2 * args.board_size ** 2
    else:
        max_moves = args.max_moves or 512

    model_options = ()
    if args.model == "randwire":
        model_options = (("channels", args.channels),)
        if args.blocks:
            model_options = (("num_blocks", args.blocks),) + model_options

    nbt = {}
    if args.block == "nbt":
        nbt = dict(block="nbt", gpool_channels=args.gpool_channels,
                   gpool_every=args.gpool_every)

    total_steps = args.iterations * args.train_steps
    return PipelineConfig(
        game=args.game,
        board_size=args.board_size,
        game_options=tuple(game_options),
        model=ResNetConfig(num_blocks=args.blocks or 6, channels=args.channels,
                           **nbt),
        model_kind=args.model,
        model_options=model_options,
        selfplay=SelfPlayConfig(
            mcts=MCTSConfig(num_simulations=args.simulations,
                            wave_size=args.wave),
            max_moves=max_moves,
            recycle=args.recycle,
        ),
        learner=LearnerConfig(
            learning_rate=args.lr,
            weight_decay=args.weight_decay,
            scheduler=args.scheduler,
            total_steps=total_steps,
            warmup_steps=max(total_steps // 100, 1),
        ),
        iterations=args.iterations,
        games_per_iteration=args.games_per_iteration,
        train_steps_per_iteration=args.train_steps,
        train_batch_size=args.train_batch_size,
        replay_capacity=args.replay_capacity,
        min_replay_before_training=args.min_replay,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        inference=args.inference or production.INFERENCE,
        seed=args.seed,
    )


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    args = build_parser().parse_args(argv)

    from alphazero_tpu_torch.parallel import distributed
    from alphazero_tpu_torch.training.pipeline import Pipeline, PipelineConfig

    distributed.initialize(device=args.device)  # torchrun's environment

    if args.config:
        from alphazero_tpu_torch.utils.config import load_config

        pipe = Pipeline(load_config(PipelineConfig, args.config),
                        device=args.device)
        if args.resume:
            logging.info("resumed from %s", pipe.restore_checkpoint())
        pipe.run()
        return
    pipe = Pipeline(pipeline_config(args), device=args.device)
    if args.resume:
        logging.info("resumed from checkpoint %s", pipe.restore_checkpoint())
    if args.games_dir:
        n = pipe.ingest_record_files(args.games_dir)
        logging.info("offline training on %d positions", n)
        pipe.run_training_only(args.iterations)
    else:
        pipe.run()


if __name__ == "__main__":
    main()
