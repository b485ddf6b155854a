"""Where one search wave's chess env work goes on the card.

Plays ``--roots`` random games on the card (seeded; lane b plays ``b %
(plies + 1)`` uniform legal moves), repeats each root ``--wave`` times as
the leaves of one wave, and runs what the search runs on them
(``profile_go_env.profile_wave``): the leaves read back from arena rows,
one legal move each through ``step``, then ``legal_mask`` and
``observation`` of the children.  Prints one JSON line: each part's
milliseconds, the host syncs of one wave, and, from ``torch.profiler``
over one wave, the device time, the kernel launches and the top kernels
and operators.

    python -m alphazero_tpu_torch.scripts.profile_chess_env --plies 40
"""
from __future__ import annotations

import argparse
import json


def random_playouts(env, B: int, max_plies: int, gen, device="cuda"):
    """Seeded random chess playouts on ``device`` (``gen``'s): lane b plays
    ``b % (max_plies + 1)`` moves drawn uniformly from its legal moves;
    games that end stop there."""
    import torch

    from alphazero_tpu_torch.core.types import where_lanes

    plies = torch.arange(B, device=device) % (max_plies + 1)
    st = env.init(B, device=device)
    for ply in range(max_plies):
        w = env.legal_mask(st).float()
        w = torch.where(w.sum(1, keepdim=True) > 0, w, torch.ones_like(w))
        acts = torch.multinomial(w, 1, generator=gen)[:, 0]
        st = where_lanes(plies > ply, env.step(st, acts), st)
    return st


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--roots", type=int, default=1024)
    p.add_argument("--wave", type=int, default=16)
    p.add_argument("--plies", type=int, default=40)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--top", type=int, default=12)
    args = p.parse_args(argv)

    import torch

    from alphazero_tpu_torch.games.chess import ChessEnv
    from alphazero_tpu_torch.scripts.profile_go_env import profile_wave

    if not torch.cuda.is_available():
        raise SystemExit("profile_chess_env needs a CUDA card")
    env = ChessEnv()
    gen = torch.Generator(device="cuda").manual_seed(8)
    starts = random_playouts(env, args.roots, args.plies, gen)
    print(json.dumps({"game": "chess", "roots_plies": f"0-{args.plies}",
                      **profile_wave(env, starts, args.wave, args.reps, args.top,
                                     gen)}), flush=True)


if __name__ == "__main__":
    main()
