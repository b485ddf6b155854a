"""Batched array-arena MCTS, wave path (counterpart of
``alphazero_tpu/mcts/search.py``).

B independent trees live in fixed-capacity struct-of-arrays arenas and
advance in lockstep: each wave runs W virtual-loss PUCT descents per lane,
then one batched env step + evaluation over the B*W leaves, a W-row install
at arena slots ``[base, base + W)``, the child links and one combined
backprop.  The root keeps dense [B, A] edge statistics; deeper nodes keep
``K = max_children`` prior-ranked child slots.

Where the JAX search reads arena rows through one-hot einsum sweeps (a
per-lane row read serialises into row DMAs on a TPU), the port reads every
per-lane arena row through ``ops.gather_rows``: on a GPU it is a coalesced
load of just the rows needed, and the arenas read at one index (a level's
node rows, a wave's leaf rows) come in one launch (``gather_rows_many``).  So the TPU workarounds are gone: child
pointers and slot actions are int32, the board arena is plain int8 rows, and
child visit/value statistics are read exactly (the JAX path reads them
through bf16, ``_radix_gather_rows``, which is inexact above 256).  Slot
priors stay bf16 as in JAX, so PUCT sees the same priors.

The port updates the arenas in place: ``_simulate_wave`` mutates and returns
the tree it is given.

Ties resolve as in JAX: top-K takes the lowest action first (a stable
descending sort) and PUCT takes the first maximum (``torch.argmax``).

Not ported yet: the W=1 sequential path, ``parity_mode``, ``td_lambda``,
the transposition table and tree reuse (``reroot``, ``HostReuseSearch``);
their config flags raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Tuple

import torch

from alphazero_tpu_torch.core.types import terminal_value
from alphazero_tpu_torch.ops.gather_rows import gather_rows, gather_rows_many

# eval_fn: (obs [B, C, H, W], to_play [B] i32) -> (logits [B, A], value [B])
EvalFn = Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]

UNVISITED = -1


@dataclasses.dataclass(frozen=True)
class MCTSConfig:
    """Search knobs; the same fields and defaults as the JAX ``MCTSConfig``."""

    num_simulations: int = 800
    c_puct: float = 1.5
    dirichlet_alpha: float = 0.3
    dirichlet_epsilon: float = 0.25
    fpu_reduction: float = 0.0
    unvisited_q: str = "zero"  # "zero" | "parent"
    diversity_bonus: bool = False
    parity_mode: bool = False
    max_children: int = 32
    max_depth: int = 128
    td_lambda: float | None = None
    tree_reuse: bool = False
    reuse_cap: int = 512
    reuse_budget: str = "topup"
    renoise_every: int = 2
    tt_size: int = 0
    wave_size: int = 1
    virtual_loss: float = 3.0

    @property
    def waves(self) -> int:
        return -(-self.num_simulations // self.wave_size)

    @property
    def num_nodes(self) -> int:
        slots = self.waves * self.wave_size
        if self.tree_reuse:
            return self.reuse_cap + slots
        return slots + 1


def check_ported(config: MCTSConfig) -> None:
    """Raise for the config options whose code paths are not ported yet."""
    missing = []
    if config.wave_size <= 1:
        missing.append("wave_size=1 (the sequential _simulate_once path)")
    if config.parity_mode:
        missing.append("parity_mode")
    if config.td_lambda is not None:
        missing.append("td_lambda")
    if config.tt_size:
        missing.append("tt_size (transposition table)")
    if config.tree_reuse:
        missing.append("tree_reuse (reroot / HostReuseSearch)")
    if missing:
        raise NotImplementedError(
            "not yet ported to alphazero_tpu_torch: " + ", ".join(missing)
        )


@dataclasses.dataclass
class Tree:
    """B fixed-capacity arenas of N nodes; node 0 is the root.

    ``value_sum`` accumulates from the perspective of the player to move at
    each node, so a child's Q seen from its parent is -value_sum/visits."""

    root_prior: torch.Tensor  # f32 [B, A]
    root_child: torch.Tensor  # i32 [B, A]; -1 unexpanded
    root_evisits: torch.Tensor  # i32 [B, A]
    root_evalue: torch.Tensor  # f32 [B, A] value sums (child perspective)
    visits: torch.Tensor  # i32 [B, N]
    value_sum: torch.Tensor  # f32 [B, N]
    parent: torch.Tensor  # i32 [B, N]; -1 at root
    terminal: torch.Tensor  # bool [B, N]
    tvalue: torch.Tensor  # f32 [B, N]
    depth: torch.Tensor  # i32 [B, N]
    paction: torch.Tensor  # i32 [B, N]; -1 root
    pslot: torch.Tensor  # i32 [B, N]; -1 from root
    prior: torch.Tensor  # bf16 [B, N, K]
    cchild: torch.Tensor  # i32 [B, N, K]; -1 unexpanded, -2 pad
    caction: torch.Tensor  # i32 [B, N, K]; -1 pad
    states: Tuple[torch.Tensor, ...]  # env.arena_rows per node: [B, N, row]

    @property
    def batch_size(self) -> int:
        return self.visits.shape[0]

    @property
    def capacity(self) -> int:
        return self.visits.shape[1]

    @property
    def num_actions(self) -> int:
        return self.root_prior.shape[-1]


class SearchOutput(NamedTuple):
    visit_counts: torch.Tensor  # i32 [B, A]
    action_weights: torch.Tensor  # f32 [B, A]
    root_value: torch.Tensor  # f32 [B]
    tree: Tree


def masked_softmax(logits: torch.Tensor, legal: torch.Tensor) -> torch.Tensor:
    """Softmax over legal actions, exact zeros elsewhere, uniform-over-legal
    fallback."""
    neg = torch.finfo(logits.dtype).min
    masked = torch.where(legal, logits, neg)
    p = torch.softmax(masked, dim=-1)
    p = torch.where(legal, p, 0.0)
    total = p.sum(dim=-1, keepdim=True)
    n_legal = legal.sum(dim=-1, keepdim=True).clamp(min=1)
    uniform = legal.to(p.dtype) / n_legal
    return torch.where(total > 0, p / total.clamp(min=1e-30), uniform)


def _topk_masked_prior(logits: torch.Tensor, legal: torch.Tensor, K: int):
    """Top-K prior slots from the masked logits plus one logsumexp.
    Equal logits keep the lowest action first.  Rows with no legal action
    get all-zero slot priors.  Returns (topv f32 [B, K], topa i64 [B, K])."""
    neg = -1e30
    masked = torch.where(legal, logits.float(), neg)
    topl, topa = torch.sort(masked, dim=-1, descending=True, stable=True)
    topl, topa = topl[:, :K], topa[:, :K]
    lse = torch.logsumexp(masked, dim=-1, keepdim=True)
    topv = torch.where(topl > 0.5 * neg, torch.exp(topl - lse), 0.0)
    return topv, topa


def _puct(prior, child_visits, child_value, node_visits, node_value,
          config: MCTSConfig) -> torch.Tensor:
    """PUCT scores [B, S]; -inf on zero-prior (pad/illegal) slots.  The
    arithmetic follows the JAX ``_puct`` operation by operation."""
    cv = child_visits.float()
    q_visited = -child_value / cv.clamp(min=1.0)
    if config.unvisited_q == "parent":
        q_un = (node_value - config.fpu_reduction)[:, None]
    else:
        q_un = torch.zeros_like(node_value)[:, None]
    q = torch.where(cv > 0, q_visited, q_un)
    u = (config.c_puct * prior
         * torch.sqrt(node_visits.clamp(min=1).float())[:, None]
         / (1.0 + cv))
    score = q + u
    if config.diversity_bonus:
        score = score + torch.where((cv > 0) & (cv < 5), 0.05 * (5 - cv), 0.0)
    return torch.where(prior > 0, score, float("-inf"))


def instantiate_tree(env, root_states, root_logits, root_value,
                     config: MCTSConfig,
                     generator: torch.Generator | None = None) -> Tree:
    """Allocate the arenas and install the evaluated roots.  With
    ``dirichlet_epsilon > 0`` the root priors are mixed with Dirichlet noise
    drawn from ``generator``, or from the device's default generator when
    none is given (the JAX search always noises the root)."""
    B, A = root_logits.shape
    N = config.num_nodes
    K = min(config.max_children, A)
    dev = root_logits.device

    legal = env.legal_mask(root_states)
    prior = masked_softmax(root_logits.float(), legal)
    if config.dirichlet_epsilon > 0:
        alpha = torch.full((B, A), config.dirichlet_alpha, device=dev)
        noise = torch._standard_gamma(alpha, generator=generator)
        noise = torch.where(legal, noise, 0.0)
        noise = noise / noise.sum(-1, keepdim=True).clamp(min=1e-30)
        eps = config.dirichlet_epsilon
        prior = (1 - eps) * prior + eps * noise
        prior = torch.where(legal, prior, 0.0)

    states = []
    for row in env.arena_rows(root_states):
        arena = torch.zeros((B, N) + row.shape[1:], dtype=row.dtype, device=dev)
        arena[:, 0] = row
        states.append(arena)
    term = env.terminal_flag(root_states)
    tval = terminal_value(env.winner(root_states), env.to_play(root_states))
    root_v = torch.where(term, tval, root_value.float())

    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    visits = torch.zeros((B, N), **i32)
    visits[:, 0] = 1
    value_sum = torch.zeros((B, N), **f32)
    value_sum[:, 0] = root_v
    terminal = torch.zeros((B, N), dtype=torch.bool, device=dev)
    terminal[:, 0] = term
    tvalue = torch.zeros((B, N), **f32)
    tvalue[:, 0] = tval
    return Tree(
        root_prior=prior.float(),
        root_child=torch.full((B, A), -1, **i32),
        root_evisits=torch.zeros((B, A), **i32),
        root_evalue=torch.zeros((B, A), **f32),
        visits=visits,
        value_sum=value_sum,
        parent=torch.full((B, N), -1, **i32),
        terminal=terminal,
        tvalue=tvalue,
        depth=torch.zeros((B, N), **i32),
        paction=torch.full((B, N), -1, **i32),
        pslot=torch.full((B, N), -1, **i32),
        prior=torch.zeros((B, N, K), dtype=torch.bfloat16, device=dev),
        cchild=torch.full((B, N, K), -2, **i32),
        caction=torch.full((B, N, K), -1, **i32),
        states=tuple(states),
    )


class _WaveSelect(NamedTuple):
    leaf: torch.Tensor  # i32 [B, W]
    action: torch.Tensor  # i64 [B, W] env action of the expansion edge
    slot: torch.Tensor  # i64 [B, W] child slot at the leaf (-1 at root)
    root_action: torch.Tensor  # i64 [B, W]
    leaf_terminal: torch.Tensor  # bool [B, W]
    path_nodes: torch.Tensor  # i64 [B, W * D] nodes on each walker's path
    path_signs: torch.Tensor  # f32 [B, W * D] +1 even depth, -1 odd, 0 pad
    length: torch.Tensor  # i32 [B, W] depth of the leaf


def _col(x: torch.Tensor) -> torch.Tensor:
    """[B, N] -> [B, N, 1]: a per-node scalar as one-element arena rows."""
    return x[:, :, None]


def _select_wave(tree: Tree, config: MCTSConfig, W: int) -> _WaveSelect:
    """W lockstep virtual-loss PUCT descents per lane.

    Two walkers on the same node have walked the same path, so virtual loss
    only interacts between same-level same-node walkers: each level's
    choices are resolved in walker order on the gathered [B, W, K] rows,
    which reproduces fully sequential virtual loss (as in JAX)."""
    B, N = tree.visits.shape
    K = tree.prior.shape[-1]
    A = tree.num_actions
    dev = tree.visits.device
    VL = float(config.virtual_loss)

    visits_f = tree.visits.float()
    vsum_f = tree.value_sum

    # --- root level: rank-ordered dense PUCT ---
    root_term = tree.terminal[:, 0]
    nv0 = visits_f[:, 0]
    nval0 = vsum_f[:, 0] / nv0.clamp(min=1)
    ev = tree.root_evisits.float()
    ew = tree.root_evalue
    extra = torch.zeros((B, A), device=dev)
    ones = torch.ones((B, 1), device=dev)
    root_actions = []
    for w in range(W):
        sc = _puct(tree.root_prior, ev + VL * extra, ew + VL * extra,
                   nv0 + VL * w, nval0, config)
        a_w = torch.argmax(sc, dim=-1)
        extra = extra.scatter_add(1, a_w[:, None], ones)
        root_actions.append(a_w)
    root_action = torch.stack(root_actions, 1)  # i64 [B, W]
    child0 = gather_rows(_col(tree.root_child), root_action)[..., 0]

    done = root_term[:, None] | (child0 == UNVISITED)
    node = torch.where(done, 0, child0).to(torch.int32)
    path_nodes = [torch.zeros_like(node), node]
    path_signs = [torch.ones((B, W), device=dev),
                  torch.where(done, 0.0, -1.0)]
    slot = torch.full((B, W), -1, dtype=torch.int64, device=dev)
    leaf_terminal = root_term[:, None].expand(B, W).clone()
    length = torch.where(done, 0, 1).to(torch.int32)

    stats = torch.stack([visits_f, vsum_f], dim=-1)  # f32 [B, N, 2]
    term_arena = _col(tree.terminal)
    krange = torch.arange(K, device=dev)
    depth = 1
    while depth < config.max_depth and bool((~done).any()):
        live = ~done
        # The rows every walker reads at its node, in one launch.
        term_here, prior_row, child_row, nstats = gather_rows_many(
            (term_arena, tree.prior, tree.cchild, stats), node)
        term_here = term_here[..., 0]
        prior_row = prior_row.float()  # [B, W, K]; child_row i32 [B, W, K]
        cidx = child_row.clamp(min=0).reshape(B, W * K)
        cstats = gather_rows(stats, cidx).reshape(B, W, K, 2)
        has_child = child_row >= 0
        cv = torch.where(has_child, cstats[..., 0], 0.0)
        cw = torch.where(has_child, cstats[..., 1], 0.0)
        nv, nw = nstats[..., 0], nstats[..., 1]  # nstats [B, W, 2]
        node_value = nw / nv.clamp(min=1.0)

        extra_k = torch.zeros((B, W, K), device=dev)
        samec = torch.zeros((B, W), device=dev)
        ks = []
        for w in range(W):
            sc = _puct(prior_row[:, w], cv[:, w] + VL * extra_k[:, w],
                       cw[:, w] + VL * extra_k[:, w],
                       nv[:, w] + VL * samec[:, w], node_value[:, w], config)
            k_w = torch.argmax(sc, dim=-1)
            same = (node == node[:, w:w + 1]) & live & live[:, w:w + 1]
            # A walker stopping on a terminal node adds node virtual loss
            # (its path ends here) but no edge choice.
            picks = same & ~term_here[:, w:w + 1]
            oh_k = (k_w[:, None] == krange[None, :]).float()
            extra_k = extra_k + picks[:, :, None].float() * oh_k[:, None, :]
            samec = samec + same.float()
            ks.append(k_w)
        k_star = torch.stack(ks, 1)  # i64 [B, W]

        child = child_row.gather(2, k_star[..., None])[..., 0].clamp(min=-1)
        stop_term = live & term_here
        stop_expand = live & ~term_here & (child == UNVISITED)
        advance = live & ~term_here & (child != UNVISITED)

        node = torch.where(advance, child, node)
        sign = 1.0 if (depth + 1) % 2 == 0 else -1.0
        path_nodes.append(node)
        path_signs.append(torch.where(advance, sign, 0.0))
        slot = torch.where(stop_expand | advance, k_star, slot)
        leaf_terminal = leaf_terminal | stop_term
        done = done | stop_term | stop_expand
        length = torch.where(advance, length + 1, length)
        depth += 1

    # The expansion edge's env action: one slot-action row read per walker.
    act_row = gather_rows(tree.caction, node)  # i32 [B, W, K]
    slot_action = act_row.gather(2, slot.clamp(min=0)[..., None])[..., 0]
    action = torch.where(slot < 0, root_action, slot_action.long())
    return _WaveSelect(
        leaf=node,
        action=action,
        slot=slot,
        root_action=root_action,
        leaf_terminal=leaf_terminal,
        path_nodes=torch.stack(path_nodes, 2).reshape(B, -1).long(),
        path_signs=torch.stack(path_signs, 2).reshape(B, -1),
        length=length,
    )


def _install(arr: torch.Tensor, base: int, values: torch.Tensor,
             keep: torch.Tensor) -> None:
    """arr[:, base:base+W] = where(keep, values, old), in place."""
    W = values.shape[1]
    old = arr[:, base:base + W]
    kb = keep.reshape(keep.shape + (1,) * (old.dim() - 2))
    arr[:, base:base + W] = torch.where(kb, values.to(arr.dtype), old)


def _link(arr2d: torch.Tensor, target: torch.Tensor, link: torch.Tensor,
          new: torch.Tensor) -> None:
    """arr2d[b, target[b, w]] = new[b, w] for every linking walker, in place.

    Every walker writes (one scatter); a non-linking walker writes the value
    its cell will hold anyway (the linking walker's value when one targets
    the same cell, else the current one), so the scatter has no conflicting
    writes.  ``target`` is int64 [B, W]."""
    B, W = target.shape
    cur = gather_rows(arr2d[:, :, None], target)[..., 0]
    match = (target[:, :, None] == target[:, None, :]) & link[:, None, :]
    src = match.to(torch.int32).argmax(dim=2)
    val = torch.where(match.any(dim=2), new.expand(B, W).gather(1, src), cur)
    arr2d.scatter_(1, target, val.to(arr2d.dtype))


def _simulate_wave(env, eval_fn: EvalFn, tree: Tree, base: int,
                   config: MCTSConfig) -> Tree:
    """One wave of ``W = config.wave_size`` simulations per lane, with the
    new nodes installed at arena slots ``[base, base + W)``.

    Two walkers reaching the same unexpanded edge are merged: the
    duplicate's visit and value land on the first walker's node."""
    B, N = tree.visits.shape
    K = tree.prior.shape[-1]
    W = config.wave_size
    dev = tree.visits.device

    sel = _select_wave(tree, config, W)
    leafs, actions = sel.leaf, sel.action
    expand0 = ~sel.leaf_terminal
    lengths, slots = sel.length, sel.slot
    from_root = slots < 0

    # --- merge duplicate expansions (same leaf, same edge) ---
    wr = torch.arange(W, device=dev)
    same = ((leafs[:, :, None] == leafs[:, None, :])
            & (actions[:, :, None] == actions[:, None, :])
            & expand0[:, :, None] & expand0[:, None, :]
            & (wr[None, :, None] >= wr[None, None, :]))
    first = same.to(torch.int32).argmax(dim=2)  # first True wins
    first = torch.where(expand0, first, wr[None, :])
    expand = expand0 & (first == wr[None, :])

    # --- batched leaf pipeline over B*W ---
    # The leaves' state rows and terminal values, in one launch (the
    # installs and links below write neither at an existing node).
    *rows, leaf_tval = gather_rows_many(tree.states + (_col(tree.tvalue),), leafs)
    rows = [r.reshape(B * W, -1) for r in rows]
    leaf_state = env.from_arena_rows(*rows)
    child_state = env.step(leaf_state, actions.reshape(-1))
    obs = env.observation(child_state)
    child_to_play = env.to_play(child_state)
    logits, value = eval_fn(obs, child_to_play)
    legal = env.legal_mask(child_state)
    topv, topa = _topk_masked_prior(logits, legal, K)
    child_term = env.terminal_flag(child_state)
    child_tval = terminal_value(env.winner(child_state), child_to_play)

    def bw(x):
        return x.reshape((B, W) + x.shape[1:])

    topv_w, topa_w = bw(topv), bw(topa)
    cterm_w, ctval_w, value_w = bw(child_term), bw(child_tval), bw(value.float())

    # --- install W rows per arena (block writes at scalar offset base) ---
    for arena, row in zip(tree.states, env.arena_rows(child_state)):
        _install(arena, base, bw(row), expand)
    _install(tree.prior, base, topv_w, expand)
    _install(tree.cchild, base, torch.where(topv_w > 0, -1, -2), expand)
    _install(tree.caction, base, torch.where(topv_w > 0, topa_w, -1), expand)
    _install(tree.parent, base, torch.where(expand, leafs, -1), expand)
    _install(tree.terminal, base, cterm_w, expand)
    _install(tree.tvalue, base, ctval_w, expand)
    _install(tree.depth, base, lengths + 1, expand)
    _install(tree.paction, base, torch.where(expand, actions, -1), expand)
    _install(tree.pslot, base, torch.where(expand, slots, -1), expand)

    # --- links: root edges and deep (leaf, slot) edges to base + w ---
    new_ids = (base + wr)[None, :]
    _link(tree.root_child, sel.root_action, expand & from_root, new_ids)
    deep_target = leafs.long() * K + slots.clamp(min=0)
    _link(tree.cchild.view(B, N * K), deep_target, expand & ~from_root, new_ids)

    # --- combined backprop ---
    leaf_val = torch.where(~expand0, leaf_tval[..., 0],
                           torch.where(cterm_w, ctval_w, value_w))
    L = lengths + expand0.to(torch.int32)  # backprop start depth
    sgn = torch.where(L % 2 == 0, leaf_val, -leaf_val)
    D = sel.path_nodes.shape[1] // W
    path_sgn = (sel.path_signs.reshape(B, W, D) * sgn[:, :, None]).reshape(B, -1)
    zeros = torch.zeros((B, N), device=dev)
    vis_add = zeros.scatter_add(1, sel.path_nodes, sel.path_signs.abs())
    val_add = zeros.scatter_add(1, sel.path_nodes, path_sgn)
    tree.visits += vis_add.to(torch.int32)
    tree.value_sum += val_add

    # New-node stats: duplicates redirect onto the canonical walker's node.
    contrib = (first[:, :, None] == wr[None, None, :]) & expand0[:, :, None]
    tree.visits[:, base:base + W] += contrib.sum(dim=1).to(torch.int32)
    tree.value_sum[:, base:base + W] += torch.where(
        contrib, leaf_val[:, :, None], 0.0).sum(dim=1)

    # --- root edge stats (child-perspective sums; child at depth 1) ---
    backed = (lengths >= 1) | (expand0 & from_root)
    sign1 = torch.where(L % 2 == 1, leaf_val, -leaf_val)
    tree.root_evisits.scatter_add_(1, sel.root_action, backed.to(torch.int32))
    ev_add = torch.zeros_like(tree.root_evalue).scatter_add(
        1, sel.root_action, torch.where(backed, sign1, 0.0))
    tree.root_evalue += ev_add
    return tree


def _finalize(tree: Tree) -> SearchOutput:
    counts = tree.root_evisits
    weights = counts / counts.sum(-1, keepdim=True).clamp(min=1)
    root_value = tree.value_sum[:, 0] / tree.visits[:, 0].clamp(min=1)
    return SearchOutput(visit_counts=counts, action_weights=weights.float(),
                        root_value=root_value, tree=tree)


def search(env, eval_fn: EvalFn, root_states, config: MCTSConfig,
           generator: torch.Generator | None = None) -> SearchOutput:
    """Run ``config.num_simulations`` simulations (in whole waves) from the
    given roots; Dirichlet noise comes from ``generator`` (default: the
    device's default generator)."""
    check_ported(config)
    with torch.no_grad():
        obs = env.observation(root_states)
        logits, value = eval_fn(obs, env.to_play(root_states))
        tree = instantiate_tree(env, root_states, logits, value, config,
                                generator)
        W = config.wave_size
        for t in range(config.waves):
            tree = _simulate_wave(env, eval_fn, tree, 1 + t * W, config)
        return _finalize(tree)


def select_action(generator: torch.Generator | None, visit_counts: torch.Tensor,
                  temperature) -> torch.Tensor:
    """Temperature action selection over root visit counts ([B, A] -> [B]
    i32); T == 0 is argmax.  Rows with no visits (terminal roots) return
    action 0 (the env's terminal step is a no-op)."""
    B = visit_counts.shape[0]
    dev = visit_counts.device
    counts = visit_counts.float()
    temp = torch.as_tensor(temperature, dtype=torch.float32, device=dev)
    temp = temp.expand(B) if temp.dim() == 0 else temp
    t = temp.clamp(min=1e-6)[:, None]
    logits = torch.where(counts > 0, torch.log(counts.clamp(min=1)) / t,
                         float("-inf"))
    any_visits = counts.sum(-1) > 0
    safe = torch.where(any_visits[:, None], logits, 0.0)
    u = torch.rand(counts.shape, generator=generator, device=dev)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
    sampled = torch.argmax(safe + gumbel, dim=-1)
    greedy = torch.argmax(counts, dim=-1)
    pick = torch.where(temp <= 1e-6, greedy, sampled)
    return torch.where(any_visits, pick, 0).to(torch.int32)


def make_host_search(env, eval_fn: EvalFn, config: MCTSConfig):
    """``(root_states, generator=None) -> SearchOutput``: the search driven
    wave by wave from Python (the JAX version's host loop)."""
    check_ported(config)

    def run(root_states, generator: torch.Generator | None = None) -> SearchOutput:
        return search(env, eval_fn, root_states, config, generator)

    return run
