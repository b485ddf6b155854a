"""Is the int8 executor's loss against the folded bf16 net the JAX
package's own?  ``models_zoo/flagship_gomoku15`` at full width through both
packages' production int8 executors (``production.py``: s8 residual, bf16
heads, 99.99-percentile calibration), each calibrated on the same
numpy-made observations, and each compared with its own BN-folded bf16 net
on the same 256 random-play positions: how often the two nets' best legal
move agree, and their mean value difference.  The port's figures must lie
within a stated margin of JAX's.

The production executor calibrates on rollouts of the net's own policy
(256 games, plies 0, 4, 8, 12); here 32 games of uniformly random legal
moves at the same plies, made with numpy, the same for both packages.  Most
of the file's time is JAX's XLA:CPU int8 convolution (about 30 s for the
256 positions on one core)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import serialization

from alphazero_tpu.models import io as jio
from alphazero_tpu.models import quant as jq
from alphazero_tpu.models.resnet import make_inference_eval_fn as jax_folded
from alphazero_tpu_torch import production
from alphazero_tpu_torch.games.gomoku import GomokuEnv
from alphazero_tpu_torch.models import quant as tq
from alphazero_tpu_torch.models.io import load_model
from alphazero_tpu_torch.models.resnet import make_inference_eval_fn
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

BUNDLE = "models_zoo/flagship_gomoku15"
OBS = (11, 15, 15)
AGREE_MARGIN = 0.03  # best-move agreement, absolute
VALUE_MARGIN = 0.005  # mean |value difference|, absolute


def _random_play(games: int, plies: tuple, seed: int):
    """Observations (numpy) and legal masks after uniformly random legal
    moves (numpy draws) at each of ``plies``, ``games`` boards a ply."""
    env = GomokuEnv(board_size=15)
    rng = np.random.RandomState(seed)
    states = env.init(games, device="cpu")
    obs, legal = [], []
    for ply in range(max(plies) + 1):
        mask = env.legal_mask(states).numpy()
        if ply in plies:
            obs.append(env.observation(states).float().numpy())
            legal.append(mask)
        action = np.array([rng.choice(np.flatnonzero(m)) for m in mask])
        states = env.step(states, torch.from_numpy(action))
    return np.concatenate(obs), np.concatenate(legal)


def _jax_load():
    """``alphazero_tpu.models.io.load_model`` with its template made by one
    compiled ``model.init`` (eagerly, flax's init compiles each op apart)."""
    with open(BUNDLE + ".json") as f:
        meta = json.load(f)
    model, _ = jio.build_model(meta["kind"], meta["num_actions"], meta["config"])
    template = jax.jit(model.init)(jax.random.key(0), jnp.zeros((1,) + OBS))
    with open(BUNDLE, "rb") as f:
        return model, serialization.from_bytes(template, f.read())


def _figures(int8, folded, legal):
    """(best legal move agreement, mean |value difference|)."""
    (il, iv), (fl, fv) = int8, folded
    il, fl = (np.where(legal, np.asarray(x, np.float32), -np.inf) for x in (il, fl))
    agree = float(np.mean(il.argmax(-1) == fl.argmax(-1)))
    return agree, float(np.abs(np.asarray(iv) - np.asarray(fv)).mean())


def test_int8_executor_loses_what_jax_loses():
    """Best-move agreement within 0.03 and mean value error within 0.005
    of JAX's (measured: JAX 0.9297 and 0.0509, the port 0.9141 and
    0.0518)."""
    calib, _ = _random_play(32, (0, 4, 8, 12), seed=1)
    obs, legal = _random_play(64, (6, 14, 22, 30), seed=2)
    kw = dict(chunk=production.INT8_CHUNK, residual=production.INT8_RESIDUAL,
              heads=production.INT8_HEADS,
              calib_percentile=production.INT8_CALIB_PERCENTILE)
    assert (kw["residual"], kw["heads"], kw["calib_percentile"]) == ("int8", "bf16", 99.99)
    assert obs.shape[0] == 256 and legal.any(-1).all()

    jmodel, jvars = _jax_load()
    jint8 = jax.jit(jq.make_int8_eval_fn(jmodel, jvars, calib_obs=jnp.asarray(calib), **kw))
    jax_fig = _figures(jint8(jnp.asarray(obs)),
                       jax.jit(jax_folded(jmodel, jvars))(jnp.asarray(obs)), legal)

    model, _ = load_model(BUNDLE, OBS, device="cpu")
    tint8 = tq.make_int8_eval_fn(model, calib_obs=torch.from_numpy(calib), **kw)
    t = torch.from_numpy(obs)
    port_fig = _figures(tint8(t), make_inference_eval_fn(model)(t), legal)

    print(f"int8 against folded bf16, best-move agreement and mean value error: "
          f"JAX {jax_fig}, port {port_fig}")
    assert abs(port_fig[0] - jax_fig[0]) <= AGREE_MARGIN, (port_fig, jax_fig)
    assert abs(port_fig[1] - jax_fig[1]) <= VALUE_MARGIN, (port_fig, jax_fig)
