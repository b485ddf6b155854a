"""Search-tree inspection: analysis summaries and DOT export (counterpart
of ``alphazero_tpu/mcts/inspect.py``), reading the port's torch arenas on
any device."""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def _host(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def top_moves(tree, game_index: int = 0, k: int = 10) -> List[Dict]:
    """Top-k root actions by visit count with Q and prior."""
    evisits = _host(tree.root_evisits[game_index])
    evalue = _host(tree.root_evalue[game_index])
    prior = _host(tree.root_prior[game_index]).astype(np.float32)
    rows = []
    for a in np.nonzero(evisits > 0)[0]:
        v = int(evisits[a])
        q = float(-evalue[a] / v) if v else 0.0
        rows.append({
            "action": int(a), "visits": v, "q": round(q, 4),
            "prior": round(float(prior[a]), 4),
        })
    rows.sort(key=lambda r: -r["visits"])
    return rows[:k]


def search_info(tree, game_index: int = 0) -> Dict:
    """Aggregate stats: nodes, depth, root value and, with a transposition
    table, its canonical hits, stores and hit rate."""
    visits = _host(tree.visits[game_index])
    parent = _host(tree.parent[game_index])
    used = visits > 0
    depth = np.zeros(len(parent), np.int32)
    for i in range(1, len(parent)):
        if parent[i] >= 0:
            depth[i] = depth[parent[i]] + 1
    root_v = float(_host(tree.value_sum[game_index, 0]) / max(visits[0], 1))
    info = {
        "nodes": int(used.sum()),
        "root_visits": int(visits[0]),
        "root_value": round(root_v, 4),
        "max_depth": int(depth[used].max()) if used.any() else 0,
        "mean_depth": round(float(depth[used].mean()), 2) if used.any()
        else 0.0,
    }
    if getattr(tree, "tt", None) is not None:
        hits = int(tree.tt.hits[game_index])
        stores = int(tree.tt.stores[game_index])
        lookups = hits + stores  # == canonical expansions
        info["tt_hits"] = hits
        info["tt_stores"] = stores
        info["tt_hit_rate"] = round(hits / lookups, 4) if lookups else 0.0
    return info


def to_dot(tree, game_index: int = 0, max_nodes: int = 50,
           min_visits: int = 1) -> str:
    """DOT digraph of the most-visited subtree (render with graphviz)."""
    visits = _host(tree.visits[game_index])
    values = _host(tree.value_sum[game_index])
    parent = _host(tree.parent[game_index])
    cchild = _host(tree.cchild[game_index]).astype(int)
    caction = _host(tree.caction[game_index]).astype(int)
    root_child = _host(tree.root_child[game_index])  # [A]

    order = np.argsort(-visits)
    keep = [i for i in order[:max_nodes] if visits[i] >= min_visits]
    keep_set = set(int(i) for i in keep)
    lines = ["digraph mcts {", "  node [shape=box, fontsize=10];"]
    for i in keep:
        v = int(visits[i])
        q = float(values[i] / v) if v else 0.0
        lines.append(
            f'  n{i} [label="#{i}\\nN={v}\\nV={q:.3f}"];'
        )
    for i in keep:
        p = int(parent[i])
        if i != 0 and p < 0:  # root child: find its action
            acts = np.nonzero(root_child == i)[0]
            if len(acts):
                lines.append(f'  n0 -> n{i} [label="{int(acts[0])}"];')
            continue
        if p >= 0 and p in keep_set:
            slots = np.nonzero(cchild[p] == i)[0]
            lbl = str(int(caction[p][slots[0]])) if len(slots) else "?"
            lines.append(f'  n{p} -> n{i} [label="{lbl}"];')
    lines.append("}")
    return "\n".join(lines)
