"""Readings that the limits of ``correct`` are set from, on the card.

    python3 perfbench/control.py --workload <cell> --seeds 11 12 13 ... [--seconds 1]

For each seed, in one process: the cell as ``run.py`` runs it, with a
short window (its recorded steps are checked as in every run), which gives
the program's readings; then the control on the same rows, which gives the
control's.  The control is the configuration's ``control``:

* ``plain_int``: the plain net (``reference/net.py``) computed in
  ``bits``-bit integers, the precision below the one the configuration
  states;
* ``program_int8``: the program's own int8 executor (``models/quant.py``)
  with the configuration's int8 knobs, on the same weights.

One JSON line a seed: every number compared, for the program and for the
control, and each one's ``correct`` under the cell's committed limits (the
control has to read not correct).  The benchmark's own runs never run the
control.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_outputs(cell, rows: dict, weights: dict, seed: int, device):
    """(logits, value) of the configuration's control on ``rows['obs']``."""
    import torch

    from perfbench.reference import net as ref_net

    spec = cell.config["control"]
    nb = int(cell.config["net"]["num_blocks"])
    w = {k: v.to(device) for k, v in weights.items()}
    if spec["kind"] == "plain_int":
        return ref_net.forward_blocks(w, rows["obs"].to(device), nb,
                                      bits=int(spec["bits"]))
    if spec["kind"] == "program_int8":
        from alphazero_tpu_torch.core import registry
        from alphazero_tpu_torch.models.resnet import AZResNet, ResNetConfig

        game = cell.config["game"]
        env = registry.create_game(game["name"], game["board_size"],
                                   **game.get("options", {}))
        with torch.device(device):
            model = AZResNet(env.num_actions, ResNetConfig(**cell.config["net"]),
                             env.observation_shape).eval()
        model.load_state_dict(w, strict=False)
        from perfbench import harness

        gen = torch.Generator(device=device).manual_seed(
            harness.seed_for(seed, "control"))
        fn = cell.kind._executor(env, model, dict(spec, kind="int8"), gen, device)
        outs = [fn(rows["obs"][i:i + 4096].to(device))
                for i in range(0, rows["obs"].shape[0], 4096)]
        return (torch.cat([o[0].float().cpu() for o in outs]),
                torch.cat([o[1].float().cpu() for o in outs]))
    raise ValueError(f"unknown control {spec['kind']!r}")


def readings(cell, seed: int, seconds: float, device, log=print) -> dict:
    """One seed: the program's numbers and verdict from a short run of the
    cell, and the control's numbers on the same rows with the verdict the
    cell's ``limits`` give them (``harness.verdict``, as every run's).  The
    control is judged on the executor's numbers; the env's and the search's
    are the program's run's."""
    import torch

    from perfbench import compare, harness

    t0 = time.perf_counter()
    ctx = harness.Context(device=device, seed=seed, seconds=seconds,
                          trace=False, config=cell.config, mix=cell.mix,
                          t_start=t0, log=log)
    out = cell.kind.run(ctx)
    oc = out["outcome"]
    limits = cell.spec["limits"]
    _, prog_correct = harness.verdict(oc.numbers, limits)
    line = {"seed": seed,
            "program": {"correct": prog_correct, "numbers": oc.numbers},
            "info": oc.info}
    if oc.rows:
        lg, v = control_outputs(cell, oc.rows, out["plain_weights"], seed,
                                device)
        numbers = dict(oc.numbers, **compare.gaps(
            lg, v, oc.rows["ref_logits"], oc.rows["ref_value"], oc.rows["legal"]))
        checks, correct = harness.verdict(numbers, limits)
        line["control"] = {"correct": correct, "checks": checks,
                           "numbers": numbers}
    line["s"] = time.perf_counter() - t0
    del out, oc
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench import harness

    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.find_cell(args.workload)
    for seed in args.seeds:
        line = readings(cell, seed, args.seconds, device,
                        log=lambda m: print(m, file=sys.stderr))
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
