"""Batched array-arena MCTS (counterpart of ``alphazero_tpu/mcts/search.py``).

B independent trees live in fixed-capacity struct-of-arrays arenas and
advance in lockstep: each wave runs W virtual-loss PUCT descents per lane,
then one batched env step + evaluation over the B*W leaves, a W-row install
at arena slots ``[base, base + W)``, the child links and one combined
backprop.  W=1 is JAX's sequential ``_simulate_once``: one descent and one
new node a simulation (identity slots in parity mode), with the TD(lambda)
backprop when ``td_lambda`` is set.  The root keeps dense [B, A] edge
statistics; deeper nodes keep ``K = max_children`` prior-ranked child
slots.

Where the JAX search reads arena rows through one-hot einsum sweeps (a
per-lane row read serialises into row DMAs on a TPU), the port reads every
per-lane arena row through ``ops.gather_rows``: on a GPU it is a coalesced
load of just the rows needed, and the arenas read at one index (a level's
node rows, a wave's leaf rows, a transposition-table slot, the survivors
of a reroot) come in one launch (``gather_rows_many``).  So the TPU
workarounds are gone: child pointers and slot actions are int32, the board
arena is plain int8 rows, table keys are whole int64 hashes, and child
visit/value statistics are read exactly (the JAX wave path reads them
through bf16, ``_radix_gather_rows``, which is inexact above 256).  Slot
priors stay bf16 as in JAX, so PUCT sees the same priors.

The port updates the arenas in place: ``_simulate_wave`` mutates and returns
the tree it is given.

Ties resolve as in JAX: top-K takes the lowest action first (a stable
descending sort) and PUCT takes the first maximum (``torch.argmax``).

Tree reuse between moves: ``reroot`` compacts the played child's subtree to
the front of a new arena, and ``HostReuseSearch`` drives it move by move.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Tuple

import torch

from alphazero_tpu_torch.core.types import terminal_value
from alphazero_tpu_torch.ops.gather_rows import gather_rows, gather_rows_many
from alphazero_tpu_torch.utils import telemetry

# eval_fn: (obs [B, C, H, W], to_play [B] i32) -> (logits [B, A], value [B])
EvalFn = Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]

UNVISITED = -1
ROOT = 0  # every tree's root is node 0 of its lane's arena


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


def check_config(config: MCTSConfig) -> None:
    """The JAX search's ``ValueError``s: ``tt_size`` must be a power of two,
    and TD(lambda) and parity mode need the sequential path (W=1)."""
    if config.tt_size & (config.tt_size - 1):
        raise ValueError("tt_size must be a power of two")
    if config.wave_size > 1 and (config.td_lambda is not None
                                 or config.parity_mode):
        raise ValueError("wave_size > 1 is incompatible with td_lambda / "
                         "parity_mode (use the sequential path)")


@dataclasses.dataclass
class TTable:
    """Per-lane direct-mapped transposition table (``MCTSConfig.tt_size``):
    slot ``hash & (S - 1)`` (the low 32 bits, JAX's ``h[1]``) holds the whole
    64-bit key and the stored position's value and top-K slots.  Misses
    always replace; within a wave the first writer to a slot wins."""

    key: torch.Tensor  # i64 [B, S] position hash
    valid: torch.Tensor  # bool [B, S]
    value: torch.Tensor  # f32 [B, S] cached leaf value (to-play perspective)
    topv: torch.Tensor  # bf16 [B, S, K] cached top-K prior
    topa: torch.Tensor  # i32 [B, S, K] cached top-K env actions
    hits: torch.Tensor  # i32 [B] lookup hits (canonical walkers)
    stores: torch.Tensor  # i32 [B] store attempts (canonical misses)


def _tt_init(B: int, S: int, K: int, device) -> TTable:
    i32 = dict(dtype=torch.int32, device=device)
    return TTable(
        key=torch.zeros((B, S), dtype=torch.int64, device=device),
        valid=torch.zeros((B, S), dtype=torch.bool, device=device),
        value=torch.zeros((B, S), dtype=torch.float32, device=device),
        topv=torch.zeros((B, S, K), dtype=torch.bfloat16, device=device),
        topa=torch.full((B, S, K), -1, **i32),
        hits=torch.zeros((B,), **i32),
        stores=torch.zeros((B,), **i32),
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
    tt: TTable | None = None  # when config.tt_size > 0

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
    arithmetic follows the JAX ``_puct`` operation by operation.  Parity
    mode adds the diversity bonus and scores unvisited legal slots
    ``1e6 - slot``, so they are taken first, in slot order."""
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
    if config.diversity_bonus or config.parity_mode:
        score = score + torch.where((cv > 0) & (cv < 5), 0.05 * (5 - cv), 0.0)
    if config.parity_mode:
        slot = torch.arange(prior.shape[-1], device=prior.device,
                            dtype=torch.float32)
        score = torch.where((cv == 0) & (prior > 0), 1e6 - slot, score)
    return torch.where(prior > 0, score, float("-inf"))


def _root_prior(env, root_states, root_logits, config: MCTSConfig,
                generator: torch.Generator | None, noise: bool = True):
    """The dense root prior: the masked softmax, mixed with Dirichlet noise
    drawn from ``generator`` (or the device's default generator when none is
    given, as the JAX search always noises the root) where ``noise`` and
    ``dirichlet_epsilon > 0``."""
    with telemetry.span("env.legal"):
        legal = env.legal_mask(root_states)
    prior = masked_softmax(root_logits.float(), legal)
    if noise and config.dirichlet_epsilon > 0:
        alpha = torch.full(prior.shape, config.dirichlet_alpha,
                           device=prior.device)
        dirichlet = torch._standard_gamma(alpha, generator=generator)
        dirichlet = torch.where(legal, dirichlet, 0.0)
        dirichlet = dirichlet / dirichlet.sum(-1, keepdim=True).clamp(min=1e-30)
        eps = config.dirichlet_epsilon
        prior = (1 - eps) * prior + eps * dirichlet
        prior = torch.where(legal, prior, 0.0)
    return prior.float()


def _root_terminal(env, root_states, root_value):
    """(terminal flag, terminal value, root value) of the roots."""
    with telemetry.span("env.result"):
        term = env.terminal_flag(root_states)
        tval = terminal_value(env.winner(root_states), env.to_play(root_states))
    return term, tval, torch.where(term, tval, root_value.float())


def instantiate_tree(env, root_states, root_logits, root_value,
                     config: MCTSConfig,
                     generator: torch.Generator | None = None,
                     tt: TTable | None = None) -> Tree:
    """Allocate the arenas and install the evaluated roots (root prior as
    ``_root_prior``).  With ``config.tt_size`` the tree carries a
    transposition table: a copy of ``tt`` where one is given (a warm start
    from an earlier search), else an empty one."""
    check_config(config)
    B, A = root_logits.shape
    N = config.num_nodes
    K = min(config.max_children, A)
    dev = root_logits.device
    prior = _root_prior(env, root_states, root_logits, config, generator)
    if not config.tt_size:
        tt = None
    elif tt is None:
        tt = _tt_init(B, config.tt_size, K, dev)
    else:
        tt = TTable(**{f.name: getattr(tt, f.name).clone()
                       for f in dataclasses.fields(tt)})

    states = []
    for row in env.arena_rows(root_states):
        arena = torch.zeros((B, N) + row.shape[1:], dtype=row.dtype, device=dev)
        arena[:, 0] = row
        states.append(arena)
    term, tval, root_v = _root_terminal(env, root_states, root_value)

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
        tt=tt,
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
    if config.parity_mode:
        # The reference adds virtual loss to the root twice a simulation and
        # removes it once, so its PUCT parent count is 4(n - 1) + 3.
        nv0 = 4 * (nv0 - 1) + 3
    ev = tree.root_evisits.float()
    ew = tree.root_evalue
    extra = torch.zeros((B, A), device=dev)
    ones = torch.ones((B, 1), device=dev)
    root_actions = []
    for w in range(W):
        sc = _puct(tree.root_prior, ev + VL * extra, ew + VL * extra,
                   nv0 + VL * w, nval0, config)
        a_w = torch.argmax(sc, dim=-1)
        if W > 1:
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
    while depth < config.max_depth:
        more = (~done).any()
        with telemetry.host_sync("search.select"):
            more = bool(more)
        if not more:
            break
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
            ks.append(k_w)
            if W == 1:
                break
            same = (node == node[:, w:w + 1]) & live & live[:, w:w + 1]
            # A walker stopping on a terminal node adds node virtual loss
            # (its path ends here) but no edge choice.
            picks = same & ~term_here[:, w:w + 1]
            oh_k = (k_w[:, None] == krange[None, :]).float()
            extra_k = extra_k + picks[:, :, None].float() * oh_k[:, None, :]
            samec = samec + same.float()
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


def _tt_process(tt: TTable, h: torch.Tensor, lookup_elig: torch.Tensor,
                store_elig: torch.Tensor, value: torch.Tensor,
                topv: torch.Tensor, topa: torch.Tensor):
    """Lookup-then-store against the per-lane table, in place (JAX
    ``_tt_process``).  ``h`` i64 [B, W] leaf hashes; ``lookup_elig`` the
    expanding non-terminal walkers, ``store_elig`` their canonical subset;
    ``value`` [B, W], ``topv``/``topa`` [B, W, K] the evaluator's output.
    Returns (value, topv, topa) with hits' cached entries substituted.

    The slot rows are read with one ``gather_rows_many``.  Misses store,
    the first writer a slot in the wave winning; every walker then writes
    its slot in one scatter an array, the storing walker's entry or the row
    it read, so no two writes to one cell differ.  Hits and stores count
    canonical walkers only (a wave duplicate shares its canonical walker's
    verdict), so ``hits + stores`` is the number of canonical expansions."""
    B, W = value.shape
    K = topv.shape[-1]
    S = tt.key.shape[1]
    idx = h & (S - 1)  # i64 [B, W]: the low bits of the key's low word
    key_row, valid_row, val_row, topv_row, topa_row = gather_rows_many(
        (_col(tt.key), _col(tt.valid), _col(tt.value), tt.topv, tt.topa), idx)
    key_row, valid_row, val_row = key_row[..., 0], valid_row[..., 0], val_row[..., 0]
    hit = lookup_elig & valid_row & (key_row == h)
    hit3 = hit[..., None]
    value2 = torch.where(hit, val_row, value)
    topv2 = torch.where(hit3, topv_row.to(topv.dtype), topv)
    topa2 = torch.where(hit3, topa_row.to(topa.dtype), topa)

    want = store_elig & ~hit
    same_slot = idx[:, :, None] == idx[:, None, :]
    wr = torch.arange(W, device=h.device)
    earlier = same_slot & want[:, None, :] & (wr[None, None, :] < wr[None, :, None])
    store = want & ~earlier.any(2)
    match = same_slot & store[:, None, :]  # [B, W(target), W(writer)]
    writer = match.to(torch.int32).argmax(2)
    written = match.any(2)

    def entry(new, row):
        if new.dim() == 2:
            return torch.where(written, new.gather(1, writer), row)
        picked = new.gather(1, writer[..., None].expand(B, W, K))
        return torch.where(written[..., None], picked, row)

    idx3 = idx[..., None].expand(B, W, K)
    tt.key.scatter_(1, idx, entry(h, key_row))
    tt.valid.scatter_(1, idx, written | valid_row)
    tt.value.scatter_(1, idx, entry(value.float(), val_row))
    tt.topv.scatter_(1, idx3, entry(topv.to(torch.bfloat16), topv_row))
    tt.topa.scatter_(1, idx3, entry(topa.to(torch.int32), topa_row))
    tt.hits += (hit & store_elig).sum(1, dtype=torch.int32)
    tt.stores += want.sum(1, dtype=torch.int32)
    return value2, topv2, topa2


def _backprop_td(tree: Tree, start: torch.Tensor, leaf_val: torch.Tensor,
                 config: MCTSConfig):
    """Leaf-to-root backprop with TD(lambda) mixing, in place (JAX
    ``_backprop_td``, the reference's ``useTemporalDifference``): update
    the node, then read its parent's mean after that update and carry
    ``v <- (1 - lambda) * (-parent_mean) + lambda * (-v)`` to the parent.
    ``start`` i64 [B] is the first node.  Returns (edge_val f32 [B], the
    value applied at the depth-1 node before its mixing; edge_hit bool
    [B])."""
    B = start.shape[0]
    dev = start.device
    lam = torch.tensor(config.td_lambda, dtype=torch.float32, device=dev)
    one_minus = 1.0 - lam
    node, val = start, leaf_val
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    edge_val = torch.zeros((B,), dtype=torch.float32, device=dev)
    edge_hit = torch.zeros((B,), dtype=torch.bool, device=dev)
    parent_col = _col(tree.parent)
    stats_cols = (_col(tree.value_sum), _col(tree.visits))
    while True:
        more = active.any()
        with telemetry.host_sync("search.backprop_td"):
            more = bool(more)
        if not more:
            break
        tree.visits.scatter_add_(1, node[:, None], active.to(torch.int32)[:, None])
        tree.value_sum.scatter_add_(1, node[:, None],
                                    torch.where(active, val, 0.0)[:, None])
        par = gather_rows(parent_col, node)[:, 0].long()
        at_depth1 = active & (par == 0)
        pv_sum, pv_n = gather_rows_many(stats_cols, par.clamp(min=0))
        parent_mean = pv_sum[:, 0] / pv_n[:, 0].float().clamp(min=1.0)
        # One fused multiply-add, as XLA compiles the JAX mix: the product
        # (1 - lambda) * (-mean) is not rounded before lambda * (-v) joins
        # it (exact in f64, then one rounding to f32).
        mixed = (one_minus.double() * (-parent_mean).double()
                 + (lam * (-val)).double()).float()
        edge_val = torch.where(at_depth1, val, edge_val)
        edge_hit = edge_hit | at_depth1
        active = active & (par >= 0)
        node, val = par.clamp(min=0), mixed
    return edge_val, edge_hit


def _simulate_wave(env, eval_fn: EvalFn, tree: Tree, base: int,
                   config: MCTSConfig) -> Tree:
    """One wave of ``W = config.wave_size`` simulations per lane, with the
    new nodes installed at arena slots ``[base, base + W)``.

    Two walkers reaching the same unexpanded edge are merged: the
    duplicate's visit and value land on the first walker's node.  At W=1
    this is JAX's ``_simulate_once`` (whose slot priors, the top K of the
    full masked softmax, round to the same bf16 values as
    ``_topk_masked_prior``'s), with the TD(lambda) backprop when
    ``td_lambda`` is set.  With a table (``tree.tt``) every expansion
    consults it before the evaluator's output is used."""
    B, N = tree.visits.shape
    K = tree.prior.shape[-1]
    W = config.wave_size
    dev = tree.visits.device

    with telemetry.span("search.select"):
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
    telemetry.count("search.rows", B * W)
    telemetry.count_device("search.new_nodes", expand)

    # --- batched leaf pipeline over B*W ---
    with telemetry.span("search.leaf"):
        # The leaves' state rows and terminal values, in one launch (the
        # installs and links below write neither at an existing node).
        *rows, leaf_tval = gather_rows_many(tree.states + (_col(tree.tvalue),),
                                            leafs)
        rows = [r.reshape(B * W, -1) for r in rows]
        leaf_state = env.from_arena_rows(*rows)
        with telemetry.span("env.step"):
            child_state = env.step(leaf_state, actions.reshape(-1))
        with telemetry.span("env.observe"):
            obs = env.observation(child_state)
            child_to_play = env.to_play(child_state)
    logits, value = _evaluate(eval_fn, obs, child_to_play)

    with telemetry.span("search.expand"):
        with telemetry.span("env.legal"):
            legal = env.legal_mask(child_state)
        if config.parity_mode and K == legal.shape[-1]:
            # Identity slots: slot k is action k, the reference's child order.
            topv = masked_softmax(logits.float(), legal)
            topa = torch.arange(K, device=dev).expand(topv.shape)
        else:
            topv, topa = _topk_masked_prior(logits, legal, K)
        with telemetry.span("env.result"):
            child_term = env.terminal_flag(child_state)
            child_tval = terminal_value(env.winner(child_state), child_to_play)

        def bw(x):
            return x.reshape((B, W) + x.shape[1:])

        topv_w, topa_w = bw(topv), bw(topa)
        cterm_w, ctval_w, value_w = bw(child_term), bw(child_tval), bw(value.float())

        # --- transposition table: consult before using the evaluator's
        # output, store on a miss ---
        if tree.tt is not None:
            h = bw(env.position_hash(child_state))
            value_w, topv_w, topa_w = _tt_process(
                tree.tt, h, expand0 & ~cterm_w, expand & ~cterm_w,
                value_w, topv_w, topa_w)

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
        _link(tree.cchild.view(B, N * K), deep_target, expand & ~from_root,
              new_ids)

    with telemetry.span("search.backup"):
        leaf_val = torch.where(~expand0, leaf_tval[..., 0],
                               torch.where(cterm_w, ctval_w, value_w))
        if config.td_lambda is not None:  # W == 1 (check_config)
            start = torch.where(expand[:, 0], base, leafs[:, 0].long())
            edge_val, edge_hit = _backprop_td(tree, start, leaf_val[:, 0],
                                              config)
            ra = sel.root_action
            tree.root_evisits.scatter_add_(1, ra,
                                           edge_hit.to(torch.int32)[:, None])
            tree.root_evalue += torch.zeros_like(tree.root_evalue).scatter_add(
                1, ra, torch.where(edge_hit, edge_val, 0.0)[:, None])
            return tree

        # --- combined backprop ---
        L = lengths + expand0.to(torch.int32)  # backprop start depth
        sgn = torch.where(L % 2 == 0, leaf_val, -leaf_val)
        D = sel.path_nodes.shape[1] // W
        path_sgn = (sel.path_signs.reshape(B, W, D)
                    * sgn[:, :, None]).reshape(B, -1)
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
        tree.root_evisits.scatter_add_(1, sel.root_action,
                                       backed.to(torch.int32))
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


def _evaluate(eval_fn: EvalFn, obs, to_play):
    """``eval_fn`` on one batch, in the ``eval`` span, its rows counted in
    ``eval.positions``."""
    telemetry.count("eval.positions", obs.shape[0])
    with telemetry.span("eval"):
        return eval_fn(obs, to_play)


def _evaluate_roots(env, eval_fn: EvalFn, root_states):
    with telemetry.span("env.observe"):
        obs = env.observation(root_states)
        to_play = env.to_play(root_states)
    return _evaluate(eval_fn, obs, to_play)


def _run_waves(env, eval_fn: EvalFn, tree: Tree, start: int, sims: int,
               config: MCTSConfig) -> Tree:
    """``sims`` simulations (a whole number of waves) from arena slot
    ``start``."""
    W = config.wave_size
    for t in range(sims // W):
        with telemetry.span("search.wave"):
            tree = _simulate_wave(env, eval_fn, tree, start + t * W, config)
    return tree


def search(env, eval_fn: EvalFn, root_states, config: MCTSConfig,
           generator: torch.Generator | None = None,
           tt: TTable | None = None) -> SearchOutput:
    """Run ``config.num_simulations`` simulations (in whole waves) from the
    given roots; Dirichlet noise comes from ``generator`` (default: the
    device's default generator).  ``tt`` warm-starts the transposition
    table from an earlier search's (``SearchOutput.tree.tt``), as the
    reference keeps one table a game across moves."""
    with torch.no_grad():
        with telemetry.span("search.roots"):
            logits, value = _evaluate_roots(env, eval_fn, root_states)
            tree = instantiate_tree(env, root_states, logits, value, config,
                                    generator, tt)
        tree = _run_waves(env, eval_fn, tree, 1,
                          config.waves * config.wave_size, config)
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
    wave by wave from Python (the JAX version's host loop); W=1 runs the
    sequential simulation."""
    check_config(config)

    def run(root_states, generator: torch.Generator | None = None) -> SearchOutput:
        return search(env, eval_fn, root_states, config, generator)

    return run


# ---------------------------------------------------------------------------
# Tree reuse between moves (the reference's updateWithMove): the played
# child's subtree survives as the new root.  Survivors are compacted to the
# front of a new arena in allocation order by row gathers at [B, C] indices,
# and every index into the arena is remapped.


def _depth1_ancestor(parent: torch.Tensor, max_depth: int) -> torch.Tensor:
    """i64 [B, N]: each node's depth-1 ancestor (its root edge's child), -1
    for the root and unallocated nodes, by pointer jumping in
    ceil(log2(max_depth)) gathers."""
    N = parent.shape[1]
    j = torch.arange(N, device=parent.device)
    anc = torch.where(parent == 0, j, parent.long())
    for _ in range(max(1, (max(2, max_depth) - 1).bit_length())):
        nxt = gather_rows(_col(anc), anc.clamp(min=0))[..., 0]
        anc = torch.where(anc > 0, nxt, anc)
    return anc


def reroot(env, tree: Tree, action: torch.Tensor, new_root_states,
           root_logits: torch.Tensor, root_value: torch.Tensor,
           config: MCTSConfig, generator: torch.Generator | None = None,
           noise_on: bool = True) -> Tree:
    """A new tree rooted at the child that ``action`` (i32 [B], just played)
    leads to, keeping its subtree's statistics (JAX ``reroot``).

    The first ``C = min(reuse_cap, N)`` survivors in allocation order are
    kept at slots ``[0, C)``, with depth one less, parent pointers and child
    slots remapped (links to dropped nodes become -1, pads stay -2); the
    dense root arrays come from the depth-1 survivors.  The root prior is
    rebuilt from ``root_logits`` (the evaluation of ``new_root_states``),
    noised only when ``noise_on``.  A lane whose played child was never
    expanded gets a fresh root with one visit.  The table survives.  New
    simulations allocate from slot ``reuse_cap``."""
    B, N = tree.visits.shape
    A = tree.num_actions
    K = tree.prior.shape[-1]
    C = min(config.reuse_cap, N)
    dev = tree.visits.device

    # --- survivors: nodes whose root edge is the played action ---
    child0 = gather_rows(_col(tree.root_child), action.long())[:, 0]
    reuse = child0 >= 0
    anc1 = _depth1_ancestor(tree.parent, config.max_depth + 2)
    member = (anc1 == child0[:, None]) & (tree.visits > 0) & reuse[:, None]
    new_idx = member.to(torch.int64).cumsum(1) - 1
    member &= new_idx < C
    old_to_new = torch.where(member, new_idx, -1)
    j = torch.arange(N, device=dev)
    # src[b, i] = the old index of survivor i, -1 past the last (a zero row)
    src = torch.full((B, C + 1), -1, dtype=torch.int64, device=dev)
    src.scatter_(1, torch.where(member, new_idx, C), j.expand(B, N))
    src = src[:, :C]

    scalars = (tree.visits, tree.value_sum, tree.terminal, tree.tvalue,
               tree.depth, tree.paction, tree.pslot, tree.parent)
    (visits_p, vsum_p, term_p, tval_p, depth_p, paction_p, pslot_p,
     parent_old) = (x[..., 0] for x in gather_rows_many(
         tuple(_col(x) for x in scalars), src))
    prior_p, caction_p, cchild_p, *states_p = gather_rows_many(
        (tree.prior, tree.caction, tree.cchild) + tree.states, src)
    depth_p = (depth_p - 1).clamp(min=0)
    parent_p = gather_rows(_col(old_to_new), parent_old.clamp(min=0))[..., 0]
    parent_p = torch.where(parent_old >= 0, parent_p, -1)

    # --- child links from (parent, slot) in the new frame ---
    jc = j[:C].expand(B, C)
    deep = parent_p > 0  # depth >= 2: lives in a K-slot row
    recon = torch.zeros((B, C * K + 1), dtype=torch.int64, device=dev)
    recon.scatter_(1, torch.where(deep, parent_p * K + pslot_p, C * K), jc)
    recon = recon[:, :C * K].view(B, C, K)
    cchild_new = torch.where(cchild_p >= 0,
                             torch.where(recon > 0, recon, -1), cchild_p)

    # --- dense root arrays from the depth-1 survivors ---
    d1 = torch.where(parent_p == 0, paction_p.long(), A)
    root_child = torch.zeros((B, A + 1), dtype=torch.int64, device=dev)
    root_child = root_child.scatter_(1, d1, jc)[:, :A]
    root_evisits = torch.zeros((B, A + 1), dtype=torch.int32, device=dev)
    root_evisits = root_evisits.scatter_(1, d1, visits_p)[:, :A]
    root_evalue = torch.zeros((B, A + 1), dtype=torch.float32, device=dev)
    root_evalue = root_evalue.scatter_(1, d1, vsum_p)[:, :A]

    # --- fresh root data (the whole root of a lane without reuse) ---
    prior = _root_prior(env, new_root_states, root_logits, config, generator,
                        noise=noise_on)
    term, tval, fresh_v = _root_terminal(env, new_root_states, root_value)

    def front(x_p, fresh, fill):
        """Survivors at [0, C), ``fill`` beyond, row 0 ``fresh`` where the
        lane reuses nothing."""
        out = torch.full((B, N) + x_p.shape[2:], fill, dtype=x_p.dtype, device=dev)
        out[:, :C] = x_p
        keep = reuse.reshape((B,) + (1,) * (x_p.dim() - 2))
        out[:, 0] = torch.where(keep, out[:, 0], fresh.to(x_p.dtype))
        return out

    i32 = dict(dtype=torch.int32, device=dev)
    none = torch.full((B,), -1, **i32)
    return Tree(
        root_prior=prior,
        root_child=torch.where(reuse[:, None] & (root_child > 0), root_child,
                               -1).to(torch.int32),
        root_evisits=torch.where(reuse[:, None], root_evisits, 0),
        root_evalue=torch.where(reuse[:, None], root_evalue, 0.0),
        visits=front(visits_p, torch.ones((B,), **i32), 0),
        value_sum=front(vsum_p, fresh_v, 0),
        parent=front(parent_p.to(torch.int32), none, -1),
        terminal=front(term_p, term, False),
        tvalue=front(tval_p, tval, 0),
        depth=front(depth_p, torch.zeros((B,), **i32), 0),
        paction=front(paction_p, none, -1),
        pslot=front(pslot_p, none, -1),
        prior=front(prior_p, torch.zeros((B, K), device=dev), 0),
        cchild=front(cchild_new.to(torch.int32), torch.full((B, K), -2, **i32), -2),
        caction=front(caction_p, torch.full((B, K), -1, **i32), -1),
        states=tuple(front(x, row, 0) for x, row in
                     zip(states_p, env.arena_rows(new_root_states))),
        tt=tree.tt,
    )


class HostReuseSearch:
    """Host-driven search with tree reuse between moves (JAX
    ``HostReuseSearch``; the reference's updateWithMove and its re-noise
    every ``renoise_every`` moves).

    Call ``run(root_states, generator=None)`` (or the object) each move; the
    previous move's tree is re-rooted on the action reported through
    ``notify_action``.  ``reuse_budget="topup"`` runs only the simulations
    that bring every lane's root to ``num_simulations + 1`` visits (one host
    read a move), ``"fixed"`` always ``num_simulations``; either is rounded
    up to whole waves and kept in ``last_fresh_sims``.  ``advance`` carries
    the tree through a move searched elsewhere (an arena opponent's).  Call
    ``reset()`` before root states unrelated to the last move's games."""

    def __init__(self, env, eval_fn: EvalFn, config: MCTSConfig):
        if not config.tree_reuse:
            raise ValueError("HostReuseSearch needs config.tree_reuse=True")
        check_config(config)
        self.env, self.eval_fn, self.config = env, eval_fn, config
        self.reset()

    def reset(self) -> None:
        self._tree = None
        self._last_action = None
        self._advanced = False
        self._move_idx = 0
        self.last_fresh_sims = 0  # simulations run on the last move

    def notify_action(self, action: torch.Tensor) -> None:
        """Record the action about to be played (i32 [B]); the next ``run``
        re-roots on it."""
        self._last_action = action

    def _reroot(self, action, root_states, generator, noise_on) -> Tree:
        with telemetry.span("search.reroot"):
            logits, value = _evaluate_roots(self.env, self.eval_fn,
                                            root_states)
            return reroot(self.env, self._tree, action, root_states, logits,
                          value, self.config, generator, noise_on)

    @torch.no_grad()
    def advance(self, action: torch.Tensor, new_states,
                generator: torch.Generator | None = None,
                noise_on: bool = False) -> None:
        """Re-root the kept tree through one played action without a
        search; a no-op before the first search."""
        if self._tree is None:
            return
        self._tree = self._reroot(action, new_states, generator, noise_on)
        self._last_action = None
        self._advanced = True
        self._move_idx += 1

    @torch.no_grad()
    def run(self, root_states,
            generator: torch.Generator | None = None) -> SearchOutput:
        cfg, env = self.config, self.env
        sims = cfg.num_simulations
        if self._tree is None or (self._last_action is None
                                  and not self._advanced):
            with telemetry.span("search.roots"):
                logits, value = _evaluate_roots(env, self.eval_fn, root_states)
                tree = instantiate_tree(env, root_states, logits, value, cfg,
                                        generator)
            start, n_new = 1, sims
        else:
            if self._last_action is not None:
                noise_on = self._move_idx % max(1, cfg.renoise_every) == 0
                tree = self._reroot(self._last_action, root_states, generator,
                                    noise_on)
            else:  # already re-rooted through the played moves by advance
                tree = self._tree
            start = min(cfg.reuse_cap, tree.capacity)
            if cfg.reuse_budget == "topup":
                reused = tree.visits[:, 0].min()
                with telemetry.host_sync("search.reuse_topup"):
                    reused = int(reused)
                n_new = max(0, min(sims, sims - reused + 1))
            else:
                n_new = sims
        W = cfg.wave_size
        n_new = -(-n_new // W) * W  # whole waves
        tree = _run_waves(env, self.eval_fn, tree, start, n_new, cfg)
        self._tree = tree
        self._last_action = None
        self._advanced = False
        self._move_idx += 1
        self.last_fresh_sims = n_new
        return _finalize(tree)

    __call__ = run
