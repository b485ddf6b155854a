"""End-to-end training pipeline: actor -> replay -> learner (counterpart of
``alphazero_tpu/training/pipeline.py``), on one device or data-parallel
over the ranks of a process group.

Each iteration refreshes the actor's inference parameters from the
learner's weights (``PipelineConfig.inference``: the production int8
executor re-calibrated on rollouts of the refreshed net, the BN-folded bf16
net, or the raw module), plays ``games_per_iteration`` lanes of self-play
with the host actor (or, with ``host_actor=False``, the scanned actor
``play_games``: every ``max_moves`` move, no early stop), writes the
finished positions into the replay ring and runs
``train_steps_per_iteration`` sampled AdamW steps.  Checkpoints are
``torch.save`` files holding the model and optimizer state, the update
count, the generator state and optionally the replay ring; the last three
are kept.  ``history.json`` records every iteration.

``model_kind="randwire"`` builds a ``DDWRandWireResNet`` from
``model_options`` (``models/io.build_model``); it has no BatchNorm, so its
actor runs the module as it is ("raw"), as the JAX pipeline's does.

Data parallelism (``mesh``, ``parallel/mesh.py``): each rank plays its
``games_per_iteration / n`` lanes from its own actor generator (seeded
from the seed and the rank, so ranks play different games; one rank's
actor draws from the pipeline's generator, as before), and the host
actor stops early only when every rank's lanes are done.  The records are
gathered along the lane axis before they enter the ring, so every rank
holds the whole ring in one rank's order; each training batch is drawn
whole from a generator seeded alike on every rank, each rank trains on its
share, and the learner averages the gradients (``training/learner.py``).
Rank 0 alone writes checkpoints and ``history.json``; every rank restores.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import logging
import os
import re
import resource
import time
import zlib
from typing import Dict, List, Optional

import torch

from alphazero_tpu_torch import production
from alphazero_tpu_torch.core import registry
from alphazero_tpu_torch.models import quant
from alphazero_tpu_torch.models.io import build_model
from alphazero_tpu_torch.models.resnet import (
    AZResNet, ResNetConfig, make_inference_eval_fn,
)
from alphazero_tpu_torch.parallel import distributed
from alphazero_tpu_torch.parallel import mesh as meshlib
from alphazero_tpu_torch.selfplay.actor import (
    SelfPlayConfig, SelfPlayOutput, make_host_actor, play_games,
    stack_records, value_targets, value_targets_recycled,
)
from alphazero_tpu_torch.selfplay.game_record import (
    load_records_dir, records_to_training_arrays,
)
from alphazero_tpu_torch.training import replay
from alphazero_tpu_torch.training.learner import (
    LearnerConfig, create_train_state, train_step,
)

log = logging.getLogger("alphazero_tpu_torch.pipeline")

KEEP_CHECKPOINTS = 3


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    game: str = "gomoku"
    board_size: int = 15
    game_options: tuple = ()  # sorted (key, value) pairs for the env
    model: ResNetConfig = ResNetConfig()
    model_kind: str = "resnet"  # "resnet" (``model``) | "randwire"
    model_options: tuple = ()
    selfplay: SelfPlayConfig = SelfPlayConfig()
    learner: LearnerConfig = LearnerConfig()

    iterations: int = 100
    games_per_iteration: int = 256
    train_steps_per_iteration: int = 64
    train_batch_size: int = 1024
    replay_capacity: int = 500_000
    min_replay_before_training: int = 10_000
    augment: bool = True

    checkpoint_dir: str = "checkpoints"
    checkpoint_every: int = 5
    checkpoint_replay: bool = False
    # The host-driven actor (stops once every game is done), or (False) the
    # scanned actor: all ``max_moves`` moves.
    host_actor: bool = True
    # Actor inference: "int8" (production executor), "folded" (BN folded,
    # bf16) or "raw" (the learner's module as it is; debugging only).
    inference: str = production.INFERENCE
    # The int8 executor's chunk (0: the whole batch in one piece), residual
    # form and calibration percentile (0: max-abs).
    int8_chunk: int = production.INT8_CHUNK
    int8_residual: str = production.INT8_RESIDUAL
    int8_calib_percentile: float = production.INT8_CALIB_PERCENTILE
    seed: int = 0


class Pipeline:
    """Actor/learner alternation on ``device`` (default ``cuda``), over the
    ranks of ``mesh`` (default: every rank of the current process group,
    one rank where there is none)."""

    def __init__(self, config: PipelineConfig, device="cuda", mesh=None):
        self.config = config
        self.device = torch.device(device)
        self.mesh = mesh if mesh is not None else meshlib.make_mesh()
        self.local_games = meshlib.local_batch_size(config.games_per_iteration,
                                                    self.mesh)
        self.env = registry.create_game(config.game, config.board_size,
                                        **dict(config.game_options))
        # The initial weights come from a CPU generator, so every device
        # starts from the same net.
        gen = torch.Generator().manual_seed(config.seed)
        if config.model_kind == "resnet":
            model = AZResNet(self.env.num_actions, config.model,
                             obs_shape=self.env.observation_shape,
                             generator=gen)
        else:
            model, _ = build_model(config.model_kind, self.env.num_actions,
                                   dict(config.model_options),
                                   self.env.observation_shape, gen)
        model = meshlib.replicate(self.mesh, model.to(self.device))
        self.state = create_train_state(model, config.learner)
        # Calibration and replay sampling: alike on every rank.
        self.generator = torch.Generator(device=self.device).manual_seed(
            config.seed)
        # Self-play noise and move choices: each rank its own; one rank
        # draws them from ``generator`` itself.
        self.actor_generator = self.generator
        if self.mesh.size > 1:
            actor_seed = zlib.crc32(
                f"actor:{config.seed}:{distributed.rank()}".encode())
            self.actor_generator = torch.Generator(
                device=self.device).manual_seed(actor_seed)
        self.buffer = replay.create(self.env, config.replay_capacity,
                                    self.env.num_actions, self.device)
        self.history: List[Dict] = []
        self.eval_tree = None  # the actor's current inference parameters
        self._eval_params = self._build_eval()
        self._host_step, self._host_init = make_host_actor(
            self.env, self.evaluate, config.selfplay, self.local_games,
            device=self.device, record_states=True)

    # ---- internals -------------------------------------------------------

    def _build_eval(self):
        """The actor's inference path: sets ``self._eval_transform`` (learner
        module -> inference parameters) and returns
        ``eval_params(params, obs, to_play)``."""
        cfg, env = self.config, self.env
        mode = cfg.inference
        if mode not in ("raw", "folded", "int8"):
            raise ValueError(f"unknown inference mode {mode!r}")
        model = self.state.module
        norm = getattr(model.cfg, "norm", None)  # the built model's
        if mode != "raw" and norm not in ("batch", "none"):
            log.warning("inference=%s needs a batch/none-norm AZResNet; "
                        "falling back to raw for %s (norm=%r)", mode,
                        type(model).__name__, norm)
            mode = "raw"
        self.inference_mode = mode

        if mode == "raw":
            self._eval_transform = lambda model: model
            return lambda model, obs, to_play=None: model(obs)
        if mode == "folded":
            self._eval_transform = make_inference_eval_fn
            return lambda eval_fn, obs, to_play=None: eval_fn(obs)

        int8_eval = None

        def transform(model):
            # The production executor, re-calibrated on rollouts of the
            # refreshed net itself (its BN-folded bf16 form).
            nonlocal int8_eval
            int8_eval, qp, _ = quant.make_production_eval_params(
                env, model, self.device, self.generator, cfg.int8_chunk,
                cfg.int8_residual, cfg.int8_calib_percentile)
            return qp

        self._eval_transform = transform
        return lambda qp, obs, to_play=None: int8_eval(qp, obs, to_play)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run_actor(self) -> SelfPlayOutput:
        """This rank's lanes from fresh games, then every rank's records
        gathered along the lane axis.  The host actor breaks (at 16-move
        granularity) once every lane of every rank is finished; its kept
        search tree (``tree_reuse``) is dropped first: it belongs to the
        last run's games (the JAX pipeline re-roots it onto the fresh
        boards)."""
        cfg = self.config
        if not cfg.host_actor:
            out = play_games(self.env, self.evaluate, self.actor_generator,
                             cfg.selfplay, self.local_games,
                             initial_states=self._host_init,
                             record_states=True)
            return self._gather_output(out)
        self._host_step.reset()
        states = self._host_init
        recs = []
        for t in range(cfg.selfplay.max_moves):
            states, rec = self._host_step(states, self.actor_generator)
            recs.append(rec)
            if (t + 1) % 16 == 0 and distributed.all_true(
                    bool(self.env.terminal_flag(states).all()), self.device):
                break
        return self._gather_output(stack_records(self.env, states, recs))

    def _gather_output(self, out: SelfPlayOutput) -> SelfPlayOutput:
        """Every rank's lanes in data order: [T, B] records along axis 1,
        per-lane results along axis 0."""
        if self.mesh.size == 1:
            return out
        g = self.mesh.gather
        return SelfPlayOutput(
            states=out.states.map(lambda x: g(x, 0)),
            actions=g(out.actions, 1), policies=g(out.policies, 1),
            root_values=g(out.root_values, 1), to_play=g(out.to_play, 1),
            active=g(out.active, 1), ended_winner=g(out.ended_winner, 1),
            winner=g(out.winner, 0), length=g(out.length, 0),
            move_states=out.move_states.map(lambda x: g(x, 1)))

    def _add(self, states, policy, z, mask):
        """Flatten [T, B] records into the replay ring."""
        T, B = z.shape

        def flat(x):
            return x.reshape((T * B,) + x.shape[2:])

        replay.add(self.buffer, states.map(flat), flat(policy), flat(z),
                   flat(mask))

    def ingest(self, out: SelfPlayOutput) -> None:
        """Write a self-play output into the replay ring.  With recycling
        only the moves of segments that finished inside the window train."""
        if self.config.selfplay.recycle:
            z, mask = value_targets_recycled(out)
        else:
            z, mask = value_targets(out), out.active
        self._add(out.move_states, out.policies, z, mask)

    def _sample(self) -> replay.Batch:
        """The global batch's indices and symmetries, drawn alike on every
        rank (in the order ``replay.sample`` draws them); this rank's share
        of them, sampled."""
        cfg, buf = self.config, self.buffer
        B, dev = cfg.train_batch_size, buf.policy.device
        idx = torch.randint(0, max(buf.size, 1), (B,), generator=self.generator,
                            device=dev)
        syms = None
        if cfg.augment and replay.has_dihedral(self.env):
            syms = torch.randint(0, 8, (B,), generator=self.generator,
                                 device=dev)
        idx, syms = meshlib.shard_batch(self.mesh, (idx, syms))
        return replay.sample(buf, self.env, None, idx.shape[0], cfg.augment,
                             idx=idx, syms=syms)

    def train(self) -> Dict[str, float]:
        """``train_steps_per_iteration`` sampled steps; mean metrics."""
        cfg = self.config
        total = None
        for _ in range(cfg.train_steps_per_iteration):
            batch = self._sample()
            self.state, m = train_step(self.state, batch, cfg.learner)
            step = torch.stack(list(m))
            total = step if total is None else total + step
        mean = (total / cfg.train_steps_per_iteration).tolist()
        return dict(zip(("loss", "policy_loss", "value_loss", "grad_norm"), mean))

    # ---- public API ------------------------------------------------------

    def evaluate(self, obs, to_play=None):
        """The actor's evaluator at the current inference parameters:
        ``(logits, value)`` for ``obs``."""
        return self._eval_params(self.eval_tree, obs, to_play)

    def ingest_record_files(self, games_dir: str) -> int:
        """Fill the replay ring from saved GameRecord JSONs; returns the
        number of positions ingested.  Under several ranks each rank reads
        its own shard of records and every rank's positions enter every
        rank's ring, rank by rank."""
        records = load_records_dir(games_dir)
        if not records:
            raise ValueError(f"no .json game records in {games_dir}")
        states, policy, z, mask = records_to_training_arrays(
            self.env, records, device=self.device)
        if self.mesh.size > 1:
            states, policy, z, mask = self._gather_rows(states, policy, z, mask)
        self._add(states, policy, z, mask)
        n = int(mask.sum())
        log.info("ingested %d positions from %d records in %s",
                 n, len(records), games_dir)
        return n

    def _gather_rows(self, states, policy, z, mask):
        """[T, G] arrays of every rank as [1, rows]: each rank's rows
        flattened, padded with masked-out rows to the longest rank's, and
        concatenated in data order."""
        T, G = z.shape
        rows = torch.tensor([T * G], device=self.device)
        longest = max(int(r) for r in distributed.all_gather(rows))

        def flat(x):
            x = x.reshape((T * G,) + x.shape[2:])
            pad = x.new_zeros((longest - T * G,) + x.shape[1:])
            return self.mesh.gather(torch.cat([x, pad]), 0)[None]

        return states.map(flat), flat(policy), flat(z), flat(mask)

    def run_training_only(self, iterations: int) -> List[Dict]:
        """Learner-only iterations over the current replay ring (offline
        training from records)."""
        out = []
        for it in range(iterations):
            t0 = time.perf_counter()
            metrics = self.train()
            self._sync()
            entry = {"iteration": it, "replay_size": self.buffer.size,
                     "train_s": round(time.perf_counter() - t0, 2), **metrics}
            self.history.append(entry)
            log.info("train-only iter %s: %s", it, entry)
            out.append(entry)
            if (it + 1) % self.config.checkpoint_every == 0:
                self.save_checkpoint(it)
        self.save_history()
        return out

    def run_iteration(self, it: int) -> Dict:
        t0 = time.perf_counter()
        # Refresh the actor's inference parameters from the learner.
        self.eval_tree = self._eval_transform(self.state.module)
        out = self._run_actor()
        self._sync()
        actor_s = time.perf_counter() - t0

        self.ingest(out)
        moves = int(out.length.sum())
        metrics: Dict[str, float] = {}
        train_s = 0.0
        if self.buffer.size >= self.config.min_replay_before_training:
            t0 = time.perf_counter()
            metrics = self.train()
            self._sync()
            train_s = time.perf_counter() - t0
        entry = {
            "iteration": it,
            "games": self.config.games_per_iteration,
            "games_finished": int((out.ended_winner != -2).sum()),
            "moves": moves,
            "replay_size": self.buffer.size,
            "actor_s": round(actor_s, 2),
            "train_s": round(train_s, 2),
            "moves_per_s": round(moves / max(actor_s, 1e-9), 1),
            **metrics,
            **self._resource_stats(),
        }
        self.history.append(entry)
        log.info("iter %s: %s", it, entry)
        return entry

    def _resource_stats(self) -> Dict:
        """Device memory (on the card) and host peak RSS in MB."""
        out = {}
        if self.device.type == "cuda":
            out["device_mem_mb"] = round(
                torch.cuda.memory_allocated(self.device) / 1e6, 1)
            out["device_peak_mb"] = round(
                torch.cuda.max_memory_allocated(self.device) / 1e6, 1)
        out["host_rss_mb"] = round(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e3, 1)
        return out

    def run(self, iterations: Optional[int] = None) -> List[Dict]:
        n = iterations or self.config.iterations
        for it in range(n):
            self.run_iteration(it)
            if (it + 1) % self.config.checkpoint_every == 0:
                self.save_checkpoint(it)
        self.save_history()
        return self.history

    # ---- persistence -----------------------------------------------------

    def _checkpoint_dir(self) -> str:
        return os.path.abspath(self.config.checkpoint_dir)

    def checkpoints(self) -> List[int]:
        """Iterations with a checkpoint on disk, oldest first."""
        its = []
        for path in glob.glob(os.path.join(self._checkpoint_dir(), "ckpt_*.pt")):
            m = re.fullmatch(r"ckpt_(\d+)\.pt", os.path.basename(path))
            if m:
                its.append(int(m.group(1)))
        return sorted(its)

    def _checkpoint_path(self, it: int) -> str:
        return os.path.join(self._checkpoint_dir(), f"ckpt_{it}.pt")

    def save_checkpoint(self, it: int) -> str:
        """Rank 0 writes checkpoint ``it`` (with every rank's actor
        generator); the other ranks wait for it."""
        actor_gens = distributed.all_gather_object(
            self.actor_generator.get_state())
        path = self._checkpoint_path(it)
        if distributed.rank() == 0:
            self._write_checkpoint(path, actor_gens)
        distributed.barrier()
        return path

    def _write_checkpoint(self, path: str, actor_gens: list) -> None:
        os.makedirs(self._checkpoint_dir(), exist_ok=True)
        payload = {
            "model": self.state.module.state_dict(),
            "optimizer": self.state.optimizer.state_dict(),
            "step": self.state.step,
            "generator": self.generator.get_state(),
            "actor_generators": actor_gens,
        }
        if self.config.checkpoint_replay:
            buf = self.buffer
            payload["replay"] = {
                "states": {f.name: getattr(buf.states, f.name)
                           for f in dataclasses.fields(buf.states)},
                "policy": buf.policy, "value": buf.value,
                "position": buf.position, "size": buf.size,
            }
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)
        for old in self.checkpoints()[:-KEEP_CHECKPOINTS]:
            os.remove(self._checkpoint_path(old))
        self._write_history()

    def restore_checkpoint(self, it: Optional[int] = None) -> int:
        """Load checkpoint ``it`` (default: the latest); returns ``it``."""
        its = self.checkpoints()
        if it is None:
            if not its:
                raise FileNotFoundError(
                    f"no checkpoint under {self.config.checkpoint_dir}")
            it = its[-1]
        payload = torch.load(self._checkpoint_path(it), map_location="cpu",
                             weights_only=True)
        self.state.module.load_state_dict(payload["model"])
        self.state.optimizer.load_state_dict(payload["optimizer"])
        self.state = dataclasses.replace(self.state, step=payload["step"])
        self.generator.set_state(payload["generator"])
        actor_gens = payload.get("actor_generators", [])
        if len(actor_gens) == distributed.world_size():
            self.actor_generator.set_state(actor_gens[distributed.rank()])
        if self.config.checkpoint_replay and "replay" in payload:
            r, buf = payload["replay"], self.buffer
            for name, x in r["states"].items():
                getattr(buf.states, name).copy_(x)
            buf.policy.copy_(r["policy"])
            buf.value.copy_(r["value"])
            buf.position, buf.size = r["position"], r["size"]
        return it

    def save_history(self) -> None:
        """Rank 0 writes ``history.json``."""
        if distributed.rank() == 0:
            self._write_history()

    def _write_history(self) -> None:
        os.makedirs(self._checkpoint_dir(), exist_ok=True)
        with open(os.path.join(self._checkpoint_dir(), "history.json"), "w") as f:
            json.dump(self.history, f, indent=2)
