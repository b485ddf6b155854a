"""Plain PUCT search with virtual-loss waves, for one game, in NumPy.

The semantics the benchmarked search states: each wave sends W walkers
from the root one after another; a walker takes at every node the child
slot of highest PUCT score ``q + c_puct * prior * sqrt(n) / (1 + n_child)``
(q = -mean child value, 0 for an unvisited child; the first of equal
scores), where every earlier walker of the wave that passed a node counts
as ``virtual_loss`` lost visits on the node and on the edge it took.  A
walker stops at an unexpanded edge (expansion), at a terminal node, or at
the root when the root is terminal.  The wave's leaves are evaluated
together; a new node keeps the top ``K`` moves of the masked softmax of its
logits as bfloat16 slot priors; two walkers that reach the same edge make
one node.  Then every walker backs its value up its path with alternating
signs.  The root keeps dense edge statistics and a prior mixed with
Dirichlet noise.  Root visit counts are the answer.

The replay follows the search of one lane that the program ran: the leaves
it reaches are its own, stepped and encoded by the plain env here; the
network's outputs for them are the program's (judged against the plain net
apart).  A leaf's observation must equal the one the program evaluated in
that walker's row.  Sums of a wave's values may be added on the device in
another order than here, so scores within ``TIE_TOL`` of the best count as
tied, and a tie is settled by the walker's recorded leaf.  The priors are
computed with PyTorch's own softmax and logsumexp over buffers shaped as
the program's batch (``Priors``), so the same rows round alike.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

TIE_TOL = 2e-5
F32 = np.float32


class ReplayError(Exception):
    """The program's search cannot be reproduced."""


class Priors:
    """The root prior and the wave's slot priors of one lane, computed with
    PyTorch over ``[B, A]`` and ``[B * W, A]`` buffers on ``device`` with the
    lane's rows in place (one row's result depends on its row alone)."""

    def __init__(self, B: int, W: int, A: int, K: int, lane: int,
                 gamma: torch.Tensor, eps: float, device):
        self.B, self.W, self.A, self.K, self.lane = B, W, A, K, lane
        self.gamma, self.eps, self.device = gamma, eps, device

    def root(self, logits: np.ndarray, legal: np.ndarray) -> np.ndarray:
        dev, B, A = self.device, self.B, self.A
        lg = torch.zeros((B, A), dtype=torch.float32, device=dev)
        lm = torch.ones((B, A), dtype=torch.bool, device=dev)
        lg[self.lane] = torch.from_numpy(logits).to(dev)
        lm[self.lane] = torch.from_numpy(legal).to(dev)
        neg = torch.finfo(torch.float32).min
        p = torch.softmax(torch.where(lm, lg, neg), dim=-1)
        p = torch.where(lm, p, 0.0)
        total = p.sum(dim=-1, keepdim=True)
        uniform = lm.float() / lm.sum(dim=-1, keepdim=True).clamp(min=1)
        p = torch.where(total > 0, p / total.clamp(min=1e-30), uniform)
        if self.eps > 0:
            d = torch.where(lm, self.gamma, 0.0)
            d = d / d.sum(-1, keepdim=True).clamp(min=1e-30)
            p = (1 - self.eps) * p + self.eps * d
            p = torch.where(lm, p, 0.0)
        return p[self.lane].float().cpu().numpy()

    def slots(self, logits: np.ndarray, legal: np.ndarray):
        """(bf16-rounded prior f32 [W, K], env action int [W, K])."""
        dev, W, A = self.device, self.W, self.A
        rows = slice(self.lane * W, self.lane * W + W)
        lg = torch.zeros((self.B * W, A), dtype=torch.float32, device=dev)
        lm = torch.ones((self.B * W, A), dtype=torch.bool, device=dev)
        lg[rows] = torch.from_numpy(logits).to(dev)
        lm[rows] = torch.from_numpy(legal).to(dev)
        neg = -1e30
        masked = torch.where(lm, lg, neg)
        top, act = torch.sort(masked, dim=-1, descending=True, stable=True)
        top, act = top[:, :self.K], act[:, :self.K]
        lse = torch.logsumexp(masked, dim=-1, keepdim=True)
        prior = torch.where(top > 0.5 * neg, torch.exp(top - lse), 0.0)
        prior = prior.to(torch.bfloat16).float()
        return prior[rows].cpu().numpy(), act[rows].cpu().numpy()


@dataclasses.dataclass
class LaneRecord:
    """What the program's evaluator saw and returned for one lane in one
    search: the root row, then ``W`` rows a wave."""

    root_obs: np.ndarray
    root_logits: np.ndarray
    root_value: float
    wave_obs: List[np.ndarray]
    wave_logits: List[np.ndarray]
    wave_value: List[np.ndarray]


@dataclasses.dataclass
class Replay:
    counts: np.ndarray  # int64 [A] root visit counts
    near_ties: int  # ties settled by a recorded leaf
    legal_rows: List[np.ndarray]  # legal mask of each evaluated row, in order


class _Tree:
    def __init__(self, n: int, A: int, K: int):
        self.visits = np.zeros(n, np.int64)
        self.value_sum = np.zeros(n, F32)
        self.terminal = np.zeros(n, bool)
        self.tvalue = np.zeros(n, F32)
        self.prior = np.zeros((n, K), F32)
        self.cchild = np.full((n, K), -2, np.int64)
        self.caction = np.full((n, K), -1, np.int64)
        self.state = [None] * n
        self.root_prior = np.zeros(A, F32)
        self.root_child = np.full(A, -1, np.int64)
        self.root_evisits = np.zeros(A, np.int64)
        self.root_evalue = np.zeros(A, F32)


def _puct(prior, cv, cw, nv, c_puct):
    """f32 scores in the program's operation order; -inf on zero priors."""
    q = np.where(cv > 0, -cw / np.maximum(cv, F32(1)), F32(0)).astype(F32)
    u = (F32(c_puct) * prior * np.sqrt(np.maximum(F32(nv), F32(1)))
         / (F32(1) + cv)).astype(F32)
    return np.where(prior > 0, (q + u).astype(F32), -np.inf)


def _choices(scores) -> List[int]:
    best = scores.max()
    if not np.isfinite(best):
        return [int(np.argmax(scores))]
    near = np.flatnonzero(scores >= best - TIE_TOL * max(1.0, abs(float(best))))
    first = int(np.argmax(scores))
    return [first] + [int(k) for k in near if k != first]


def replay(env, cfg: dict, root, rec: LaneRecord, priors: Priors) -> Replay:
    """Replay one lane's search from the reference state ``root``; raise
    ``ReplayError`` where the program's leaves cannot be reached."""
    W = int(cfg["wave_size"])
    sims = int(cfg["num_simulations"])
    waves = -(-sims // W)
    A = env.num_actions
    K = min(int(cfg["max_children"]), A)
    VL = F32(cfg["virtual_loss"])
    c_puct = float(cfg["c_puct"])
    max_depth = int(cfg["max_depth"])
    if cfg.get("unvisited_q", "zero") != "zero" or cfg.get("tt_size", 0):
        raise ValueError("the replay takes unvisited_q 'zero' and no table")
    if len(rec.wave_obs) != waves:
        raise ReplayError(f"{len(rec.wave_obs)} waves recorded, {waves} expected")

    t = _Tree(waves * W + 1, A, K)
    if not np.array_equal(env.observation(root), rec.root_obs):
        raise ReplayError("root observation differs")
    root_legal = env.legal(root)
    t.state[0] = root
    t.root_prior = priors.root(rec.root_logits, root_legal)
    root_term = root.terminal
    t.terminal[0] = root_term
    t.tvalue[0] = F32(env.terminal_value(root)) if root_term else F32(0)
    t.visits[0] = 1
    t.value_sum[0] = t.tvalue[0] if root_term else F32(rec.root_value)
    near_ties = 0
    legal_rows = [root_legal]

    for wave in range(waves):
        base = 1 + wave * W
        vis_f = t.visits.astype(F32)
        vsum = t.value_sum.copy()
        ev = t.root_evisits.astype(F32)
        ew = t.root_evalue.copy()
        nv0 = vis_f[0]
        xr = np.zeros(A, F32)
        xk = {}  # node -> f32 [K] edge virtual losses this wave
        samec = {}  # node -> walkers that passed it this wave
        obs_w = rec.wave_obs[wave]

        def descend(w, root_action):
            """Every outcome of walker w's descent from ``root_action``,
            branching at near ties; each (leaf, slot, path, picks, ties)."""
            outs = []
            child0 = t.root_child[root_action]
            if root_term or child0 < 0:
                return [(0, -1, [(0, 1.0)], [], 0)]

            def walk(node, depth, slot, path, picks, ties):
                if depth >= max_depth:
                    outs.append((node, slot, path, picks, ties))
                    return
                if t.terminal[node]:
                    outs.append((node, slot, path, picks + [(node, None)], ties))
                    return
                cidx = t.cchild[node]
                has = cidx >= 0
                safe = np.where(has, cidx, 0)
                cv = np.where(has, vis_f[safe], F32(0)).astype(F32)
                cw = np.where(has, vsum[safe], F32(0)).astype(F32)
                extra = xk.get(node, np.zeros(K, F32))
                nv = vis_f[node] + VL * F32(samec.get(node, 0))
                sc = _puct(t.prior[node], (cv + VL * extra).astype(F32),
                           (cw + VL * extra).astype(F32), nv, c_puct)
                ks = _choices(sc)
                for i, k in enumerate(ks):
                    child = int(cidx[k])
                    p2 = picks + [(node, k)]
                    if child < 0:
                        outs.append((node, k, path, p2, ties + (i > 0)))
                    else:
                        sign = 1.0 if (depth + 1) % 2 == 0 else -1.0
                        walk(child, depth + 1, k, path + [(child, sign)], p2,
                             ties + (i > 0))

            walk(int(child0), 1, -1, [(0, 1.0), (int(child0), -1.0)], [], 0)
            return outs

        walkers = []
        for w in range(W):
            sc = _puct(t.root_prior, (ev + VL * xr).astype(F32),
                       (ew + VL * xr).astype(F32), nv0 + VL * F32(w), c_puct)
            found = None
            tied = 0
            for ra in _choices(sc):
                for leaf, slot, path, picks, ties in descend(w, ra):
                    action = ra if slot < 0 else int(t.caction[leaf, slot])
                    st = t.state[leaf]
                    child = st if st.terminal else env.step(st, action)
                    if np.array_equal(env.observation(child), obs_w[w]):
                        found = (ra, leaf, slot, action, path, picks, child)
                        tied = ties + (ra != _choices(sc)[0])
                        break
                if found:
                    break
            if found is None:
                raise ReplayError(f"wave {wave} walker {w}: the recorded leaf "
                                  "is not reachable")
            near_ties += tied
            ra, leaf, slot, action, path, picks, child = found
            xr[ra] += 1
            for node, k in picks:
                samec[node] = samec.get(node, 0) + 1
                if k is not None:
                    xk.setdefault(node, np.zeros(K, F32))[k] += 1
            walkers.append(dict(ra=ra, leaf=leaf, slot=slot, action=action,
                                path=path, child=child,
                                term=bool(t.state[leaf].terminal)))

        # The wave's evaluation: the program's outputs for these rows.
        legal = np.stack([env.legal(wk["child"]) for wk in walkers])
        legal_rows.extend(legal)
        topv, topa = priors.slots(rec.wave_logits[wave], legal)
        value = rec.wave_value[wave].astype(F32)
        first = []
        for w, wk in enumerate(walkers):
            f = w
            if not wk["term"]:
                for j in range(w):
                    o = walkers[j]
                    if (not o["term"] and o["leaf"] == wk["leaf"]
                            and o["action"] == wk["action"]):
                        f = j
                        break
            first.append(f)
        leaf_val = []
        for w, wk in enumerate(walkers):
            child = wk["child"]
            if wk["term"]:
                leaf_val.append(t.tvalue[wk["leaf"]])
                continue
            cterm = child.terminal
            ctval = F32(env.terminal_value(child)) if cterm else F32(0)
            leaf_val.append(ctval if cterm else value[w])
            if first[w] != w:
                continue
            nid = base + w
            t.state[nid] = child
            t.prior[nid] = topv[w]
            t.cchild[nid] = np.where(topv[w] > 0, -1, -2)
            t.caction[nid] = np.where(topv[w] > 0, topa[w], -1)
            t.terminal[nid] = cterm
            t.tvalue[nid] = ctval
            if wk["slot"] < 0:
                t.root_child[wk["ra"]] = nid
            else:
                t.cchild[wk["leaf"], wk["slot"]] = nid

        vis_add = np.zeros_like(t.visits)
        val_add = np.zeros_like(t.value_sum)
        ev_add = np.zeros_like(t.root_evalue)
        for w, wk in enumerate(walkers):
            v = F32(leaf_val[w])
            expand0 = not wk["term"]
            L = (len(wk["path"]) - 1) + int(expand0)
            sgn = v if L % 2 == 0 else -v
            for node, s in wk["path"]:
                vis_add[node] += 1
                val_add[node] += F32(s) * sgn
            if expand0:
                nid = base + first[w]
                t.visits[nid] += 1
                t.value_sum[nid] += v
            if len(wk["path"]) > 1 or (expand0 and wk["slot"] < 0):
                t.root_evisits[wk["ra"]] += 1
                ev_add[wk["ra"]] += v if L % 2 == 1 else -v
        t.visits += vis_add
        t.value_sum += val_add
        t.root_evalue += ev_add

    return Replay(counts=t.root_evisits.copy(), near_ties=near_ties,
                  legal_rows=legal_rows)


def select(counts_rows: torch.Tensor, u: torch.Tensor, temperature: torch.Tensor):
    """The move of every row, as the program states it: the most visited
    (the first of equals) at temperature 0, else ``argmax(log(n) / T +
    Gumbel(u))`` over visited moves; ``u`` are the uniform draws."""
    counts = counts_rows.float()
    t = temperature.clamp(min=1e-6)[:, None]
    logits = torch.where(counts > 0, torch.log(counts.clamp(min=1)) / t,
                         float("-inf"))
    any_visits = counts.sum(-1) > 0
    safe = torch.where(any_visits[:, None], logits, 0.0)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
    sampled = torch.argmax(safe + gumbel, dim=-1)
    greedy = torch.argmax(counts, dim=-1)
    pick = torch.where(temperature <= 1e-6, greedy, sampled)
    return torch.where(any_visits, pick, 0)
