"""The port's s8 / bf16 products (``ops/s8_mm.py``) against the JAX probe
kernels themselves, run in Pallas interpret mode, and against numpy.

The probe tools under ``tools/`` take no ``interpret`` argument, so the
tests patch ``pallas_call`` with ``interpret=True`` before calling them.  On
the CPU the port's wrappers take their plain PyTorch versions; the CUDA
kernels are held against those on the card by ``chip_smoke.py`` and the
``cuda``-marked test below.
"""
import functools
import importlib.util
import pathlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from alphazero_tpu_torch.ops import s8_mm as ops
from alphazero_tpu_torch.ops.s8_mm import (
    chained_dot, chained_dot_plain, s8_mm, s8_mm_multi, s8_mm_multi_plain,
    s8_mm_plain, tiled_mm, tiled_mm_plain,
)
from alphazero_tpu_torch.scripts import profile_s8_dots as probe

TOOLS = pathlib.Path(__file__).resolve().parents[1] / "tools"


def _load_tool(name):
    """Import ``tools/<name>.py`` and put back the compile-cache settings it
    changes at import."""
    keep = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")}
    spec = importlib.util.spec_from_file_location(f"_probe_{name}", TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in keep.items():
            jax.config.update(k, v)
    return mod


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _s8(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


def _np_mm(a, b):
    return a.astype(np.int32) @ b.astype(np.int32)


@pytest.mark.parametrize("M,K,N,BM", [(64, 128, 64, 16), (96, 576, 64, 32),
                                      (48, 640, 128, 24)])
def test_s8_mm_matches_pallas_mm(interpret, M, K, N, BM):
    tool = _load_tool("profile_fused_shapes")
    rng = np.random.default_rng(0)
    a, b = _s8(rng, (M, K)), _s8(rng, (K, N))
    want = np.asarray(tool.pallas_mm(M, K, N, BM)(jnp.asarray(a), jnp.asarray(b)))
    got = s8_mm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)  # integers: exact
    np.testing.assert_array_equal(want, _np_mm(a, b))


@pytest.mark.parametrize("taps", [1, 3, 5])
@pytest.mark.parametrize("K", [64, 128, 200])
@pytest.mark.parametrize("N", [21, 64, 128])
def test_s8_mm_multi_matches_pallas_mm_multi(interpret, taps, K, N):
    tool = _load_tool("profile_fused_shapes")
    rng = np.random.default_rng(1)
    M, BM = 32, 16
    a, b = _s8(rng, (M, K)), _s8(rng, (taps, K, N))
    want = np.asarray(tool.pallas_mm_multi(M, K, N, BM, taps)(
        jnp.asarray(a), jnp.asarray(b)))
    got = s8_mm_multi(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, sum(_np_mm(a, b[t]) for t in range(taps)))


@pytest.mark.parametrize("BM,K,N,R", [(16, 128, 64, 3), (24, 128, 128, 4),
                                      (8, 576, 64, 2), (16, 64, 32, 0)])
def test_chained_dot_s8_matches_pallas(interpret, BM, K, N, R):
    tool = _load_tool("profile_inkernel_dot")
    rng = np.random.default_rng(2)
    a, b = _s8(rng, (BM, K)), _s8(rng, (K, N))
    want = np.asarray(tool.chained_dot(BM, K, N, R)(jnp.asarray(a), jnp.asarray(b)))
    got = chained_dot(torch.from_numpy(a), torch.from_numpy(b), R)
    assert got.dtype == torch.int32 and got.shape == (BM, N)
    np.testing.assert_array_equal(got.numpy(), want)
    if R:
        # the requant step wraps: some s32 >> 8 fall outside s8
        first = _np_mm(a, b) >> 8
        assert (np.abs(first) > 127).any()


@pytest.mark.parametrize("K,N", [(128, 128), (128, 64)])
def test_chained_dot_bf16_matches_pallas(interpret, K, N):
    tool = _load_tool("profile_inkernel_dot")
    rng = np.random.default_rng(3)
    BM, R = 16, 3
    a = jnp.asarray(rng.standard_normal((BM, K)), jnp.bfloat16)
    b = jnp.asarray(rng.standard_normal((K, N)), jnp.bfloat16)
    want = np.asarray(tool.chained_dot(BM, K, N, R, jnp.bfloat16)(a, b))
    ta = torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    tb = torch.from_numpy(np.asarray(b, np.float32)).to(torch.bfloat16)
    got = chained_dot(ta, tb, R)
    assert got.dtype == torch.float32
    # f32 sums in another order; a differing last bit can flip one of the
    # bf16 roundings between the products (2**-8 relative), which the later
    # products carry on: 2 % of the largest value.
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-2 * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_tiled_mm_matches_make_pallas_mm(interpret, monkeypatch, dtype):
    tool = _load_tool("profile_pallas_mm")
    M, K, N, BM = 64, 256, 128, 16
    for name, val in (("M", M), ("K", K), ("N", N), ("BM", BM)):
        monkeypatch.setattr(tool, name, val)
    rng = np.random.default_rng(4)
    if dtype == "int8":
        a, b = _s8(rng, (M, K)), _s8(rng, (K, N))
        want = np.asarray(tool.make_pallas_mm(jnp.int8, jnp.int32)(
            jnp.asarray(a), jnp.asarray(b)))
        got = tiled_mm(torch.from_numpy(a), torch.from_numpy(b))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        a = jnp.asarray(rng.standard_normal((M, K)) * 0.02, jnp.bfloat16)
        b = jnp.asarray(rng.standard_normal((K, N)) * 0.02, jnp.bfloat16)
        want = np.asarray(tool.make_pallas_mm(jnp.bfloat16, jnp.float32)(a, b))
        got = tiled_mm(torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16),
                       torch.from_numpy(np.asarray(b, np.float32)).to(torch.bfloat16))
        assert got.dtype == torch.float32
        # bf16 products are exact in f32; only the order of the f32 sums
        # differs: 1e-5 of the largest value at K = 256.
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("M,K,N", [(1, 1, 1), (37, 99, 21), (130, 577, 65),
                                   (5, 2048, 3)])
def test_ragged_shapes_match_numpy(M, K, N):
    """Any M, N, K; K = 2048 is past the float32-exact range, so the plain
    version must switch to float64."""
    rng = np.random.default_rng(5)
    a, b = _s8(rng, (M, K)), _s8(rng, (K, N))
    if K == 2048:  # worst case: every product +127 * 127
        a[:], b[:] = 127, 127
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_array_equal(s8_mm(ta, tb).numpy(), _np_mm(a, b))
    np.testing.assert_array_equal(tiled_mm(ta, tb).numpy(), _np_mm(a, b))
    b3 = _s8(rng, (3, K, N))
    np.testing.assert_array_equal(
        s8_mm_multi(ta, torch.from_numpy(b3)).numpy(),
        sum(_np_mm(a, b3[t]) for t in range(3)))


def test_wrappers_reject_bad_arguments():
    a, b = torch.zeros(4, 8, dtype=torch.int8), torch.zeros(8, 4, dtype=torch.int8)
    with pytest.raises(ValueError):
        s8_mm(a, torch.zeros(7, 4, dtype=torch.int8))
    with pytest.raises(TypeError):
        s8_mm(a.float(), b.float())
    with pytest.raises(TypeError):
        tiled_mm(a, b.to(torch.bfloat16))
    with pytest.raises(ValueError):
        s8_mm_multi(a, b)  # needs [taps, K, N]
    with pytest.raises(ValueError):
        chained_dot(torch.zeros(4, 48, dtype=torch.int8),
                    torch.zeros(48, 32, dtype=torch.int8), 1)  # K % N != 0
    with pytest.raises(ValueError):
        chained_dot(a, b, 1)  # N % 32 != 0
    with pytest.raises(ValueError):
        s8_mm(torch.zeros(8, dtype=torch.int8), b)


def test_launch_counters_count_only_kernel_launches():
    """On the CPU the plain version runs and no launch is counted."""
    before = (s8_mm.launches, s8_mm_multi.launches, tiled_mm.launches,
              chained_dot.launches)
    a, b = torch.ones(4, 32, dtype=torch.int8), torch.ones(32, 32, dtype=torch.int8)
    s8_mm(a, b), s8_mm_multi(a, b[None]), tiled_mm(a, b), chained_dot(a, b, 1)
    assert before == (s8_mm.launches, s8_mm_multi.launches, tiled_mm.launches,
                      chained_dot.launches)


# ----------------------------------------------- routing between the kernels

@pytest.mark.parametrize("N,K,route", [
    (64, 576, "resident"), (64, 99, "resident"), (32, 64, "resident"),
    (64, 128, "resident"), (128, 640, "resident"), (1, 1, "resident"),
    (8, 64, "resident"), (128, 768, "resident"),   # 6 panels x 16 KB: the limit
    (128, 769, "tiled"),                           # one panel more
    (64, 1536, "resident"), (64, 1537, "tiled"),
    (32, 3072, "resident"), (32, 3073, "tiled"),
    (129, 64, "tiled"), (256, 64, "tiled"), (2048, 2048, "tiled"),
])
def test_s8_mm_route(N, K, route):
    assert ops.s8_mm_route(N, K) == route
    assert (route == "resident") == (
        N <= 128 and ops.resident_b_bytes(N, K) <= ops.RESIDENT_B_MAX)


@pytest.mark.parametrize("taps,N,K,route", [
    (5, 64, 128, "resident"),      # the probe: 5 x 8 KB
    (6, 128, 128, "resident"),     # 6 x 16 KB = 96 KB: the limit
    (7, 128, 128, "tiled"),        # one tap more
    (5, 128, 64, "resident"), (5, 129, 64, "tiled"),  # N = 128 against 129
    (1, 128, 768, "resident"), (1, 128, 769, "tiled"),  # one tap: s8_mm's rule
    (24, 32, 128, "resident"), (25, 32, 128, "tiled"),
    (3, 32, 1024, "resident"), (3, 32, 1025, "tiled"),
    (5, 128, 576, "tiled"), (2, 65, 577, "tiled"), (9, 8, 200, "resident"),
])
def test_s8_mm_multi_route(taps, N, K, route):
    assert ops.s8_mm_multi_route(taps, N, K) == route
    assert (route == "resident") == (
        N <= 128 and taps * ops.resident_b_bytes(N, K) <= ops.RESIDENT_B_MAX)
    if taps == 1:
        assert route == ops.s8_mm_route(N, K)


_PRODUCT_CASES = [c for c in probe.trunk_cases() + probe.probe_cases(8)
                  + probe.multi_prologue_cases() + probe.edge_cases()
                  if c.kernel in ("s8_mm", "s8_mm_multi", "tiled_mm")]


@pytest.mark.parametrize("case", _PRODUCT_CASES,
                         ids=[f"{c.kernel}-{c.name}" for c in _PRODUCT_CASES])
def test_every_card_case_lands_on_a_kernel_that_takes_it(case):
    (M, K), N = case.a_shape, case.b_shape[-1]
    taps = case.b_shape[0] if case.kernel == "s8_mm_multi" else 1
    route = probe.route(case)
    assert route == {"s8_mm": ops.s8_mm_route(N, K),
                     "s8_mm_multi": ops.s8_mm_multi_route(taps, N, K),
                     "tiled_mm": "tiled"}[case.kernel]
    assert ops.kernel_accepts(route, M, N, K, case.dtype, taps)
    if route == "tiled" and case.kernel != "tiled_mm":
        assert not ops.kernel_accepts("resident", M, N, K, case.dtype, taps)


def test_edge_cases_take_both_routes_and_every_layout():
    s8 = [c for c in probe.edge_cases() if c.kernel == "s8_mm"]
    assert {ops.s8_mm_route(c.b_shape[1], c.a_shape[1]) for c in s8} == {
        "resident", "tiled"}
    assert {c.layout for c in s8} == {"dense", "strided", "misaligned", "pitched"}
    assert any(c.lowest == -128 for c in s8)
    assert any(c.a_shape[0] > 2 * 132 * 128 for c in s8)  # over two rounds


def test_multi_edge_cases_take_both_routes_and_every_layout():
    multi = [c for c in probe.edge_cases() if c.kernel == "s8_mm_multi"]
    routes = {(probe.route(c), c.b_shape[0] == 1) for c in multi}
    assert routes == {("resident", True), ("resident", False), ("tiled", True),
                      ("tiled", False)}
    assert {c.layout for c in multi} == {"dense", "strided", "misaligned", "pitched"}
    assert any(c.lowest == -128 for c in multi)
    assert any(c.a_shape[0] > 2 * 132 * 128 and c.b_shape[0] == 5 for c in multi)
    # each side of the resident limit at K = N = 128
    assert {c.b_shape for c in multi if c.b_shape[1:] == (128, 128)} >= {
        (6, 128, 128), (7, 128, 128)}
    # the tiled route at N > 128, and with taps whose images exceed 96 KB
    assert any(probe.route(c) == "tiled" and c.b_shape[2] > 128 for c in multi)
    assert any(probe.route(c) == "tiled" and c.b_shape[2] <= 128 for c in multi)
    # b read in 16-byte pieces (N % 16 == 0, the padded rows past N among
    # them), in words, byte by byte; K ragged against a 32-byte step
    assert {c.b_shape[2] % 16 == 0 for c in multi} == {True, False}
    assert any(c.b_shape[2] % 16 and c.b_shape[2] % 4 == 0 for c in multi)
    assert any(c.b_shape[2] % 16 == 0 and c.b_shape[2] not in (32, 64, 128)
               for c in multi)
    assert any(c.a_shape[1] % 32 for c in multi)


@pytest.mark.parametrize("wrapper,dtype,N,K,want", [
    ("s8_mm", torch.int8, 64, 576, "resident"),
    ("s8_mm", torch.int8, 2048, 2048, "tiled"),
    ("tiled_mm", torch.int8, 64, 576, "tiled"),
    ("tiled_mm", torch.bfloat16, 64, 576, "tiled"),
    ("s8_mm_multi", torch.int8, 64, 128, "resident"),
    ("s8_mm_multi", torch.int8, 128, 576, "tiled"),
    ("s8_mm_multi", torch.int8, 129, 64, "tiled"),
])
def test_off_the_cpu_no_wrapper_takes_a_plain_version(monkeypatch, wrapper,
                                                      dtype, N, K, want):
    """A tensor that is not on the CPU goes to a kernel launch, by the route
    its shape names, and never to ``*_plain``."""
    taken = []
    monkeypatch.setattr(ops, "_check_pair", lambda *args, **kw: None)
    monkeypatch.setattr(ops, "_launch_resident",
                        lambda a, b: taken.append("resident"))
    monkeypatch.setattr(ops, "_launch_wgmma_tiled",
                        lambda w, a, b: taken.append("tiled"))
    monkeypatch.setattr(ops, "_launch_multi",
                        lambda a, b, route: taken.append(route))

    def refuse(*args):
        raise AssertionError("a plain version was called")

    for name in ("s8_mm_plain", "s8_mm_multi_plain", "tiled_mm_plain",
                 "_int_matmul"):
        monkeypatch.setattr(ops, name, refuse)
    a = torch.empty((300, K), dtype=dtype, device="meta")
    b_shape = (5, K, N) if wrapper == "s8_mm_multi" else (K, N)
    b = torch.empty(b_shape, dtype=dtype, device="meta")
    getattr(ops, wrapper)(a, b)
    assert taken == [want]


@pytest.mark.parametrize("taps,N,K,scratch", [(5, 64, 128, None),
                                              (5, 128, 576, (128, 5 * 640)),
                                              (1, 200, 99, (200, 112))])
def test_off_the_cpu_s8_mm_multi_launches_its_kernel(monkeypatch, taps, N, K,
                                                     scratch):
    """``az_s8_mm_multi`` gets the true M, N, K, the pitch of ``a`` and the
    tap count, and scratch for the transposed taps only on the tiled
    route; the output is allocated at its true N."""
    calls, sizes = [], []
    monkeypatch.setattr(ops, "_check_pair", lambda *args, **kw: None)
    monkeypatch.setattr(ops, "_fns", SimpleNamespace(
        wg=None, multi=lambda *a: calls.append(a) or 0))
    monkeypatch.setattr(ops._build, "stream_of", lambda x: 0)
    monkeypatch.setattr(ops, "s8_mm_multi_plain", None)
    empty = torch.empty

    def record(size, **kw):
        sizes.append(tuple(size))
        return empty(size, **kw)

    monkeypatch.setattr(ops.torch, "empty", record)
    a = empty((3000, K), dtype=torch.int8, device="meta")
    b = empty((taps, K, N), dtype=torch.int8, device="meta")
    before = s8_mm_multi.launches
    out = s8_mm_multi(a, b)
    assert out.shape == (3000, N) and out.dtype == torch.int32
    assert s8_mm_multi.launches == before + 1 and len(calls) == 1
    assert calls[0][4:9] == (3000, N, K, -(-K // 16) * 16, taps)  # a's pitch
    assert sizes[0] == (3000, N)
    assert scratch in sizes if scratch else sizes == [(3000, N)]
    assert (calls[0][2] is None) == (scratch is None)


def test_kernel_accepts_mirrors_the_entry_points():
    s8, bf = torch.int8, torch.bfloat16
    assert ops.kernel_accepts("resident", 10, 128, 128, s8, taps=6)
    assert not ops.kernel_accepts("resident", 10, 128, 128, s8, taps=7)
    assert ops.kernel_accepts("tiled", 10, 128, 128, s8, taps=7)
    assert not ops.kernel_accepts("tiled", 10, 128, 128, bf, taps=2)
    assert not ops.kernel_accepts("tiled", 10, 128, 128, s8, taps=0)
    assert not ops.kernel_accepts("tiled", 10, 64, 2**20, s8, taps=2**12)
    assert ops.kernel_accepts("resident", 0, 64, 576, s8)   # nothing to do
    assert not ops.kernel_accepts("resident", 10, 64, 0, s8)
    assert not ops.kernel_accepts("resident", 10, 129, 64, s8)
    assert not ops.kernel_accepts("resident", 10, 64, 576, bf)
    assert not ops.kernel_accepts("resident", 10, 128, 769, s8)
    assert ops.kernel_accepts("tiled", 10, 129, 64, s8)
    assert ops.kernel_accepts("tiled", 1, 1, 1, bf)
    assert not ops.kernel_accepts("tiled", 10, 64 * 65535 + 1, 16, s8)
    with pytest.raises(ValueError):
        ops.kernel_accepts("plain", 1, 1, 1, s8)


# --------------------------------------------- the chained dot's wrapped form

def _requant_np(acc, dtype):
    if dtype == "int8":
        return ((acc >> 8) + 128) % 256 - 128  # wraps like the cast to s8
    return np.asarray(torch.from_numpy((acc * np.float32(0.001)).astype(np.float32))
                      .to(torch.bfloat16).float())


def _wrapped_chain(a, b, R, dtype):
    """The chain as the kernel computes it: after the first product the
    operand is only d's N columns, and tile(d, K / N) @ b is taken as
    sum_j d @ b[jN : (j+1)N]."""
    K, N = b.shape
    acc_t = np.int64 if dtype == "int8" else np.float32
    b = b.astype(acc_t)
    acc = a.astype(acc_t) @ b
    for _ in range(R):
        d = _requant_np(acc, dtype).astype(acc_t)
        acc = sum(d @ b[j * N:(j + 1) * N] for j in range(K // N))
        if dtype == "int8":  # int32 sums wrap
            acc = ((acc + 2**31) % 2**32 - 2**31)
    return acc


@pytest.mark.parametrize("dtype,M,K,N,R", [
    ("int8", 40, 576, 64, 3), ("int8", 9, 128, 128, 2), ("int8", 5, 96, 32, 4),
    ("int8", 7, 64, 64, 0), ("bfloat16", 12, 256, 128, 3),
    ("bfloat16", 6, 128, 64, 2)])
def test_chained_dot_plain_equals_the_wrapped_form(dtype, M, K, N, R):
    rng = np.random.default_rng(9)
    if dtype == "int8":
        a, b = _s8(rng, (M, K)), _s8(rng, (K, N))
        got = chained_dot_plain(torch.from_numpy(a), torch.from_numpy(b), R)
        np.testing.assert_array_equal(got.numpy(), _wrapped_chain(a, b, R, dtype))
        return
    ta = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).bfloat16()
    tb = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)).bfloat16()
    got = chained_dot_plain(ta, tb, R).numpy()
    want = _wrapped_chain(ta.float().numpy(), tb.float().numpy(), R, dtype)
    # the same f32 terms summed in another order; a flipped bf16 rounding
    # between the products is carried on (BF16_TOL of the probe script)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=probe.BF16_TOL["chained_dot"] * np.abs(want).max())


def test_chained_dot_accepts_mirrors_the_entry_point():
    """The shape rule of az_chained_smem (csrc/wgmma_mm.cu), pinned: what the
    kernel takes and the shared memory it asks for."""
    s8, bf = torch.int8, torch.bfloat16
    smem = ops.chained_dot_smem
    # s8 [576, 64]: b 5 panels x 128 B x 64 (40 KB) + band 5 x 8 KB + 1 KB
    # alignment + the barrier
    assert smem(64, 576, s8) == 1024 + 40960 + 40960 + 16
    # bf16 [128, 128]: b as it lies, 128 rows x 128 B x 2 column blocks; the
    # band 2 panels of 128 bytes
    assert smem(128, 128, bf) == 1024 + 32768 + 16384 + 16
    for N in (32, 64, 128):
        assert smem(N, N, s8) is not None
    assert smem(256, 256, s8) is None
    assert smem(32, 64, bf) is None              # bf16 b is read 64 columns a block
    assert smem(96, 192, s8) is None
    assert smem(64, 96, s8) is None              # K % N
    assert smem(64, 0, s8) is None
    assert smem(128, 1152, s8) is not None       # 9 panels: the limit
    assert smem(128, 1280, s8) is None
    assert smem(128, 512, bf) is not None and smem(128, 640, bf) is None
    assert smem(64, 576, torch.float32) is None


_CHAIN_CASES = [c for c in probe.probe_cases(8) + probe.edge_cases()
                if c.kernel == "chained_dot"]


@pytest.mark.parametrize("case", _CHAIN_CASES, ids=[c.name for c in _CHAIN_CASES])
def test_every_chained_dot_case_is_taken(case):
    (M, K), N = case.a_shape, case.b_shape[1]
    assert ops.chained_dot_smem(N, K, case.dtype)


def test_chained_dot_edge_cases_cover_its_edges():
    chains = [c for c in probe.edge_cases() if c.kernel == "chained_dot"]
    for dt in (torch.int8, torch.bfloat16):
        mine = [c for c in chains if c.dtype == dt]
        assert any(c.R == 0 for c in mine) and any(c.a_shape[0] < 64 for c in mine)
        assert any(c.a_shape[1] == c.b_shape[1] for c in mine)
        assert any(c.a_shape[0] % 64 for c in mine)
        assert any(c.a_shape[0] > 132 * 64 for c in mine)  # more bands than SMs
        # the largest K whose b fits, for N = 128
        assert any(ops.chained_dot_smem(128, c.a_shape[1] + 128, dt) is None
                   for c in mine if c.b_shape[1] == 128)
    assert {c.b_shape[1] for c in chains} == {32, 64, 128}


def test_off_the_cpu_chained_dot_launches_its_kernel(monkeypatch):
    calls = []
    monkeypatch.setattr(ops, "_check_pair", lambda *args, **kw: None)
    monkeypatch.setattr(ops, "_fns", SimpleNamespace(
        wg=None, chained=lambda *a: calls.append(a) or 0))
    monkeypatch.setattr(ops._build, "stream_of", lambda x: 0)

    def refuse(*args):
        raise AssertionError("a plain version was called")

    monkeypatch.setattr(ops, "chained_dot_plain", refuse)
    a = torch.empty((3600, 576), dtype=torch.int8, device="meta")
    b = torch.empty((576, 64), dtype=torch.int8, device="meta")
    before = chained_dot.launches
    out = chained_dot(a, b, 8)
    assert out.shape == (3600, 64) and out.dtype == torch.int32
    assert chained_dot.launches == before + 1 and len(calls) == 1
    assert calls[0][3:] == (3600, 64, 576, 576, 8, 1, 0)


@pytest.mark.parametrize("N", [32, 64, 128])
def test_s8_fragment_shuffles_rebuild_wgmma_a(N):
    """requant_to_fragments of csrc/wgmma_mm.cu, s8, in numpy: from the
    wgmma accumulator layout (lane g * 4 + t holds columns 8j + 2t, +1 of
    rows g and g + 8) to the A fragments of the next step (a[u][2 half + h]
    holds columns 32u + 16 half + 4t .. + 3 of row g + 8h), by each lane
    packing the pairs of two column groups into one word and two shuffles
    within the quad."""
    rng = np.random.default_rng(10)
    d = rng.integers(0, 256, (16, N), dtype=np.uint32)  # a warp's rows of d
    lanes = np.arange(32)
    g, t = lanes // 4, lanes % 4

    def pair(j, h):  # the requantised pair (j, h) of every lane, 16 bits
        return d[g + 8 * h, 8 * j + 2 * t] | (d[g + 8 * h, 8 * j + 2 * t + 1] << 8)

    src = (lanes & ~3) | (2 * (t & 1))
    sel = (t >> 1) * 16
    for u in range(N // 32):
        for half in range(2):
            for h in range(2):
                j0 = 4 * u + 2 * half
                packed = pair(j0, h) | (pair(j0 + 1, h) << 16)
                x, y = packed[src], packed[src + 1]  # __shfl_sync
                a = ((x >> sel) & 0xFFFF) | (((y >> sel) & 0xFFFF) << 16)
                cols = 32 * u + 16 * half + 4 * t
                want = sum(d[g + 8 * h, cols + c] << (8 * c) for c in range(4))
                np.testing.assert_array_equal(a, want)


# ------------------------------------- plain twins of what the kernels build

def _unswizzle(img, padded_n):
    """[panels, padded_n * 128] swizzled bytes -> [padded_n, panels * 128]."""
    panels = img.shape[0]
    out = np.zeros((padded_n, panels * 128), np.int8)
    for p in range(panels):
        for n in range(padded_n):
            for chunk in range(8):
                src = n * 128 + ((chunk ^ (n & 7)) << 4)
                out[n, p * 128 + 16 * chunk:p * 128 + 16 * chunk + 16] = \
                    img[p, src:src + 16]
    return out


@pytest.mark.parametrize("K,N,padded_n", [(1, 1, 32), (99, 21, 32), (99, 64, 64),
                                          (576, 64, 64), (200, 65, 128),
                                          (640, 128, 128)])
def test_pack_b_resident_plain_is_the_swizzled_transpose(K, N, padded_n):
    rng = np.random.default_rng(6)
    b = rng.integers(-128, 128, (K, N)).astype(np.int8)
    img = ops.pack_b_resident_plain(torch.from_numpy(b)).numpy()
    panels = -(-K // 128)
    assert img.shape == (panels, padded_n * 128)
    want = np.zeros((padded_n, panels * 128), np.int8)
    want[:N, :K] = b.T
    np.testing.assert_array_equal(_unswizzle(img, padded_n), want)
    # every byte sits where swizzled_offset says
    for k, n in ((0, 0), (K - 1, N - 1), (K // 2, N // 2)):
        assert img[k // 128, ops.swizzled_offset(n, k % 128)] == b[k, n]


def test_swizzled_offset_permutes_each_group_of_eight_rows():
    offs = {ops.swizzled_offset(r, k) for r in range(8) for k in range(128)}
    assert offs == set(range(1024))
    assert ops.swizzled_offset(0, 37) == 37            # row 0 is not permuted
    assert ops.swizzled_offset(1, 0) == 128 + 16       # chunk 0 ^ 1
    assert ops.swizzled_offset(9, 5) == 9 * 128 + 16 + 5


@pytest.mark.parametrize("K,N", [(1, 1), (99, 21), (577, 65), (2048, 64)])
def test_transpose_b_plain_matches_numpy(K, N):
    rng = np.random.default_rng(7)
    b = rng.integers(-128, 128, (K, N)).astype(np.int8)
    got = ops.transpose_b_plain(torch.from_numpy(b)).numpy()
    assert got.shape == (N, -(-K // 16) * 16)
    np.testing.assert_array_equal(got[:, :K], b.T)
    assert not got[:, K:].any()
    # one tap of the taps form is the same scratch
    np.testing.assert_array_equal(
        ops.transpose_b_plain(torch.from_numpy(b[None])).numpy(), got)


@pytest.mark.parametrize("taps,K,N", [(2, 1, 1), (3, 99, 21), (5, 576, 128),
                                      (2, 130, 256), (7, 128, 128), (2, 577, 65)])
def test_tap_padded_scratch_matches_numpy(taps, K, N):
    """The tiled route's scratch for ``b [taps, K, N]``: ``[N, taps * Kp]``,
    Kp = K rounded up to 128 bytes, tap t transposed at columns t * Kp, zeros
    between the taps; the product over it equals the sum over the taps."""
    rng = np.random.default_rng(11)
    b = rng.integers(-128, 128, (taps, K, N)).astype(np.int8)
    got = ops.transpose_b_plain(torch.from_numpy(b)).numpy()
    kp = -(-K // 128) * 128
    assert ops.tap_pitch(taps, K) == kp and got.shape == (N, taps * kp)
    want = np.zeros((N, taps, kp), np.int8)
    want[:, :, :K] = b.transpose(2, 0, 1)
    np.testing.assert_array_equal(got, want.reshape(N, taps * kp))
    # what the kernel's stages compute: a's K restarts at each tap against
    # the tap's columns of the scratch
    a = _s8(rng, (9, K))
    a_pad = np.zeros((9, kp), np.int8)
    a_pad[:, :K] = a
    acc = sum(_np_mm(a_pad, got[:, t * kp:(t + 1) * kp].T) for t in range(taps))
    np.testing.assert_array_equal(acc, sum(_np_mm(a, b[t]) for t in range(taps)))


@pytest.mark.parametrize("taps,K,N", [(5, 128, 64), (1, 99, 21), (6, 128, 128),
                                      (9, 200, 8), (4, 256, 48), (3, 1024, 32)])
def test_pack_b_multi_plain_stacks_the_tap_images(taps, K, N):
    """The resident kernel's image of ``b [taps, K, N]``: tap t's panels
    right after tap t - 1's, each the swizzled transpose of its 128 bytes of
    K, each on a 1024-byte boundary, all of it within the resident limit."""
    rng = np.random.default_rng(12)
    b = rng.integers(-128, 128, (taps, K, N)).astype(np.int8)
    img = ops.pack_b_multi_plain(torch.from_numpy(b)).numpy()
    panels = -(-K // 128)
    padded_n = ops.resident_b_bytes(N, K) // (panels * 128)
    assert img.shape == (taps * panels, padded_n * 128)
    assert img.nbytes == taps * ops.resident_b_bytes(N, K) <= ops.RESIDENT_B_MAX
    assert img.shape[1] % 1024 == 0  # every panel starts swizzle-aligned
    for t in range(taps):
        want = np.zeros((padded_n, panels * 128), np.int8)
        want[:N, :K] = b[t].T
        np.testing.assert_array_equal(
            _unswizzle(img[t * panels:(t + 1) * panels], padded_n), want)
    for t, k, n in ((0, 0, 0), (taps - 1, K - 1, N - 1), (taps // 2, K // 2, N // 2)):
        flat = img.reshape(-1)
        off = (t * panels + k // 128) * padded_n * 128 + ops.swizzled_offset(n, k % 128)
        assert flat[off] == b[t, k, n]


@pytest.mark.parametrize("K", [64, 1024, 1025, 2048])
def test_minus_128_is_exact_in_the_plain_versions(K):
    """The kernels' contract is s8, not the executor's [-127, 127]: the worst
    case, every product 128 * 128, against numpy in int64."""
    rng = np.random.default_rng(8)
    a = rng.integers(-128, 128, (9, K)).astype(np.int8)
    b = rng.integers(-128, 128, (K, 7)).astype(np.int8)
    a[0], b[:, 0] = -128, -128
    a[1, ::3] = -128
    want = a.astype(np.int64) @ b.astype(np.int64)
    assert want[0, 0] == K * 128 * 128
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for fn in (s8_mm_plain, tiled_mm_plain, s8_mm, tiled_mm):
        got = fn(ta, tb)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy().astype(np.int64), want)
    np.testing.assert_array_equal(
        s8_mm_multi_plain(ta, tb[None].repeat(2, 1, 1)).numpy().astype(np.int64),
        2 * want)


# ------------------------------------------------ what the wrapper hands over

def test_rows16_passes_what_tma_can_read_and_copies_the_rest():
    dense = torch.arange(40 * 64, dtype=torch.int32).to(torch.int8).reshape(40, 64)
    assert ops._rows16(dense) is dense                       # 64-byte rows
    wide = torch.arange(40 * 112, dtype=torch.int32).to(torch.int8).reshape(40, 112)
    pitched = wide[:, :99]
    assert ops._rows16(pitched) is pitched                   # pitch 112, in place
    packed = pitched.contiguous()                            # pitch 99: copied
    got = ops._rows16(packed)
    assert got.shape == (40, 99) and got.stride() == (112, 1)
    assert torch.equal(got, packed) and got.data_ptr() % 16 == 0
    strided = wide[:, ::2]                                   # column stride 2
    got = ops._rows16(strided)
    assert got.stride() == (64, 1) and torch.equal(got, strided)
    off = torch.zeros(40 * 64 + 16, dtype=torch.int8)[1:1 + 40 * 64].view(40, 64)
    if off.data_ptr() % 16:                                  # misaligned base
        got = ops._rows16(off)
        assert got is not off and got.data_ptr() % 16 == 0
    bf = torch.zeros((12, 20), dtype=torch.bfloat16)         # 40-byte rows
    assert ops._rows16(bf).stride() == (24, 1)


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    bad = [c.name for c in probe.edge_cases()
           if not probe.run_case(c, g, reps=0)["agrees"]]
    assert not bad

    def s8(*shape):
        return torch.randint(-127, 128, shape, device="cuda", generator=g,
                             dtype=torch.int8)

    for M, K, N in [(115200, 576, 64), (115200, 99, 64), (300, 577, 65), (1, 1, 1)]:
        a, b = s8(M, K), s8(K, N)
        assert torch.equal(s8_mm(a, b), s8_mm_plain(a, b))
        assert torch.equal(tiled_mm(a, b), tiled_mm_plain(a, b))
    for M, K, N, taps in [(14400, 128, 64, 5), (115200, 128, 64, 5),
                          (14400, 576, 128, 5)]:
        a, b = s8(M, K), s8(taps, K, N)
        assert torch.equal(s8_mm_multi(a, b), s8_mm_multi_plain(a, b))
    a, b = s8(3600, 576), s8(576, 64)
    assert torch.equal(chained_dot(a, b, 8), chained_dot_plain(a, b, 8))
    a = (torch.randn(512, 2048, device="cuda", generator=g) * 0.02).bfloat16()
    b = (torch.randn(2048, 256, device="cuda", generator=g) * 0.02).bfloat16()
    ref = tiled_mm_plain(a, b)
    assert float((tiled_mm(a, b) - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
