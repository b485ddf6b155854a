"""Model export and packaging CLI (counterpart of
``alphazero_tpu/scripts/export_model.py``, the same flags plus ``--device``).

Converts a training checkpoint (``ckpt_N.pt`` under ``--checkpoint-dir``)
to a (msgpack, JSON) bundle, or takes an existing ``--bundle``; then
optionally exports it as TorchScript (``--torchscript``) and ONNX
(``--onnx``), each checked against the folded net, and zips it with its
metadata (``--package``).  Prints one JSON line.

    python -m alphazero_tpu_torch.scripts.export_model \\
        --bundle models_zoo/chess_dev --torchscript chess.pt --onnx chess.onnx

With ``--bundle`` the game and board come from the bundle's action count
(4,672: chess; N * N: Gomoku N x N; N * N + 1: Go N x N); a ``--game`` or
``--board-size`` given as well must agree with it.  (The JAX CLI builds the
env from ``--game``/``--board-size`` alone, Gomoku 15 x 15 by default,
whatever the bundle holds.)
"""
from __future__ import annotations

import argparse
import glob
import json
import math
import os
import re
import time
import zipfile

import numpy as np


def game_of_actions(num_actions: int):
    """(game, board size) whose action space has ``num_actions`` actions."""
    if num_actions == 8 * 8 * 73:
        return "chess", 8
    n = math.isqrt(num_actions)
    if n * n == num_actions:
        return "gomoku", n
    n = math.isqrt(num_actions - 1)
    if n * n + 1 == num_actions:
        return "go", n
    raise ValueError(f"no game has {num_actions} actions")


def bundle_game(bundle: str, game=None, board_size=None):
    """The (game, board size) of ``bundle``, from its JSON; raises where a
    given ``game`` or ``board_size`` disagrees with it."""
    with open(bundle + ".json") as f:
        meta = json.load(f)
    want = game_of_actions(int(meta["num_actions"]))
    if (game or want[0], board_size or want[1]) != want:
        raise ValueError(
            f"{bundle} holds a {want[0]} {want[1]}x{want[1]} net "
            f"({meta['num_actions']} actions), not {game} {board_size}")
    return want


def export_from_checkpoint(checkpoint_dir, out_path, game, board_size,
                           blocks, channels, step=None):
    """Write the bundle of checkpoint ``ckpt_{step}.pt`` (default: the
    latest) of a ``blocks`` x ``channels`` ResNet run; returns the step."""
    import torch

    from alphazero_tpu_torch.core import registry
    from alphazero_tpu_torch.models.io import save_model
    from alphazero_tpu_torch.models.resnet import AZResNet, ResNetConfig

    if step is None:
        steps = [int(m.group(1)) for p in glob.glob(
            os.path.join(checkpoint_dir, "ckpt_*.pt"))
            if (m := re.fullmatch(r"ckpt_(\d+)\.pt", os.path.basename(p)))]
        if not steps:
            raise FileNotFoundError(f"no checkpoint under {checkpoint_dir}")
        step = max(steps)
    env = registry.create_game(game, board_size)
    cfg = ResNetConfig(num_blocks=blocks, channels=channels)
    model = AZResNet(env.num_actions, cfg, env.observation_shape)
    payload = torch.load(os.path.join(checkpoint_dir, f"ckpt_{step}.pt"),
                         map_location="cpu", weights_only=True)
    model.load_state_dict(payload["model"])
    save_model(out_path, model, "resnet", env.num_actions, cfg)
    return step


def package(bundle_path, zip_path, metadata=None):
    meta = {
        "format": "alphazero_tpu.bundle.v1",
        "created": time.strftime("%Y-%m-%dT%H:%M:%S"),
        **(metadata or {}),
    }
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as z:
        z.write(bundle_path, os.path.basename(bundle_path))
        z.write(bundle_path + ".json",
                os.path.basename(bundle_path) + ".json")
        z.writestr("metadata.json", json.dumps(meta, indent=2))
    return zip_path


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint-dir", default=None,
                   help="training checkpoint dir (ckpt_N.pt) to convert")
    p.add_argument("--bundle", default=None,
                   help="existing (msgpack, JSON) bundle to export directly "
                   "(e.g. models_zoo/flagship_gomoku15); mutually exclusive "
                   "with --checkpoint-dir")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--game", default=None,
                   help="game (default: the bundle's, or gomoku)")
    p.add_argument("--board-size", type=int, default=None,
                   help="board size (default: the bundle's, or 15)")
    p.add_argument("--blocks", type=int, default=6)
    p.add_argument("--channels", type=int, default=64)
    p.add_argument("--output", default="model.msgpack")
    p.add_argument("--package", default=None,
                   help="also write a distribution zip here")
    p.add_argument("--torchscript", default=None,
                   help="also export a TorchScript .pt here")
    p.add_argument("--onnx", default=None,
                   help="also export an ONNX file here (opset 13), checked "
                   "by parsing the file back and replaying it with numpy")
    p.add_argument("--device", default="cuda",
                   help="torch device of the parity checks: cuda (default) "
                   "or cpu")
    return p


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    if (args.bundle is None) == (args.checkpoint_dir is None):
        p.error("exactly one of --checkpoint-dir / --bundle is required")
    if args.bundle is not None:
        args.output = args.bundle
        game, board_size = bundle_game(args.bundle, args.game, args.board_size)
        step = None
    else:
        game, board_size = args.game or "gomoku", args.board_size or 15
        step = export_from_checkpoint(
            args.checkpoint_dir, args.output, game, board_size,
            args.blocks, args.channels, args.step)
    out = {"bundle": args.output, "checkpoint_step": step}
    if args.torchscript or args.onnx:
        from alphazero_tpu_torch.core import registry
        from alphazero_tpu_torch.models.export_onnx import (
            export_onnx, verify_onnx_export,
        )
        from alphazero_tpu_torch.models.export_torch import (
            export_torchscript, verify_export,
        )
        from alphazero_tpu_torch.models.io import load_model

        env = registry.create_game(game, board_size)
        model, _ = load_model(args.output, env.observation_shape, args.device)
        obs = np.asarray(env.observation(env.init(4, device="cpu")).float())
        if args.torchscript:
            export_torchscript(model, env.observation_shape, args.torchscript)
            out["torchscript"] = args.torchscript
            out["torchscript_parity"] = verify_export(model, obs,
                                                      args.torchscript)
        if args.onnx:
            export_onnx(model, env.observation_shape, args.onnx)
            out["onnx"] = args.onnx
            out["onnx_parity"] = verify_onnx_export(model, obs, args.onnx)
    if args.package:
        package(args.output, args.package,
                {"game": game, "board_size": board_size,
                 "checkpoint_step": step})
        out["package"] = args.package
    print(json.dumps(out))


if __name__ == "__main__":
    main()
