"""The port's wave search (W=4) on chess against JAX ``make_host_search``
with a 256-slot table: root visit counts, hits and stores, exactly.  Zero
values keep every statistic integral and 256 simulations keep every count
at or below 256, so the JAX wave path's bf16 reads of child statistics
are exact (``tests/test_torch_search.py``); 256 simulations also reach
the depth where move orders transpose.  The settings and roots are
``tests/test_torch_chess_search.py``'s."""
from test_torch_chess import one_torch_thread  # noqa: F401 (autouse)
from test_torch_chess_search import compare


def test_w4_visit_counts_and_table_match_jax():
    out = compare(wave=4, value_noise=0.0, sims=256, tt=256, seed=2)
    assert int(out.tree.tt.stores.sum()) > 0 and int(out.tree.tt.hits.sum()) > 0
