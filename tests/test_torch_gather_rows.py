"""The port's gather_rows and gather_rows_many against the JAX Pallas kernel
(interpret mode) and numpy.  On the CPU the wrappers take their plain
PyTorch versions; the CUDA kernel is held against them on the card by
chip_smoke.py and by the ``cuda``-marked test below, and its word-and-shift
plan is rehearsed here in numpy (``_kernel_bytes``)."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.ops.gather_rows import gather_rows as jax_gather_rows
from alphazero_tpu_torch.ops import gather_rows as ops
from alphazero_tpu_torch.ops.gather_rows import (
    gather_rows, gather_rows_many, gather_rows_many_plain, gather_rows_plain,
)


def test_matches_pallas_interpret_single_row():
    rng = np.random.RandomState(0)
    B, N, K = 16, 40, 32
    arr = rng.randn(B, N, K).astype(np.float32)
    idx = rng.randint(0, N, size=B).astype(np.int32)
    want = np.asarray(jax_gather_rows(jnp.asarray(arr), jnp.asarray(idx),
                                      interpret=True))
    got = gather_rows(torch.from_numpy(arr), torch.from_numpy(idx))
    assert got.shape == (B, K)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8,
                                   torch.int32])
def test_multi_row_matches_take_along_axis(dtype):
    rng = np.random.RandomState(1)
    B, N, K, M = 3, 17, 5, 9  # B need not be a multiple of 8
    arr = torch.from_numpy(rng.randint(-100, 100, size=(B, N, K))).to(dtype)
    idx = rng.randint(0, N, size=(B, M)).astype(np.int32)
    got = gather_rows(arr, torch.from_numpy(idx))
    want = np.take_along_axis(arr.float().numpy(), idx[:, :, None], axis=1)
    assert got.dtype == dtype and got.shape == (B, M, K)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_out_of_range_rows_are_zero():
    B, N, K = 2, 4, 3
    arr = torch.arange(1, B * N * K + 1, dtype=torch.float32).reshape(B, N, K)
    idx = torch.tensor([[-1, 0, 4], [3, -7, 100]], dtype=torch.int32)
    got = gather_rows(arr, idx)
    assert torch.equal(got[0, 0], torch.zeros(K))
    assert torch.equal(got[0, 1], arr[0, 0])
    assert torch.equal(got[0, 2], torch.zeros(K))
    assert torch.equal(got[1, 0], arr[1, 3])
    assert torch.equal(got[1, 1:], torch.zeros(2, K))
    boolean = gather_rows(arr > 5, idx)  # 1-byte rows, any dtype
    assert boolean.dtype == torch.bool and not bool(boolean[0, 0].any())


def test_rejects_bad_shapes():
    with pytest.raises(ValueError):
        gather_rows(torch.zeros(2, 3), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        gather_rows(torch.zeros(2, 3, 4), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(TypeError):
        gather_rows(torch.zeros(2, 3, 4), torch.zeros(2))


def _jax_rows(arr, idx):
    """The JAX kernel (interpret mode) at idx [B, M]: each (b, m) becomes a
    lane of its own, since the Pallas kernel reads one row a lane.  It does
    not check the range; the port's zero rows are pinned on top."""
    B, N, K = arr.shape
    M = idx.shape[1]
    valid = (idx >= 0) & (idx < N)
    lanes = np.repeat(arr, M, axis=0)
    got = np.asarray(jax_gather_rows(jnp.asarray(lanes),
                                     jnp.asarray(np.where(valid, idx, 0).reshape(-1)),
                                     interpret=True)).reshape(B, M, K)
    return np.where(valid[:, :, None], got, np.zeros((), got.dtype))


def test_gather_rows_many_matches_pallas_interpret():
    """Mixed dtypes and row lengths (bool, int8 with 225-byte rows, int32,
    bf16, f32), -1 and N among the indices."""
    rng = np.random.RandomState(2)
    B, N, M = 4, 9, 6  # B * M lanes: a multiple of the kernel's 8
    arenas = [rng.rand(B, N, 1) > 0.5,
              rng.randint(-128, 128, (B, N, 225)).astype(np.int8),
              rng.randint(-2**31, 2**31 - 1, (B, N, 3)).astype(np.int32),
              rng.randn(B, N, 32).astype(np.float32),
              rng.randn(B, N, 2).astype(np.float32)]
    idx = rng.randint(-1, N + 1, (B, M)).astype(np.int32)
    idx[0, :2] = -1, N
    tarr = [torch.from_numpy(a) for a in arenas]
    tarr[3] = tarr[3].to(torch.bfloat16)
    got = gather_rows_many(tarr, torch.from_numpy(idx))
    assert len(got) == len(arenas)
    for g, a, t in zip(got, arenas, tarr):
        assert g.dtype == t.dtype and g.shape == (B, M, a.shape[2])
        want = _jax_rows(t.float().numpy() if t.dtype == torch.bfloat16 else a, idx)
        np.testing.assert_array_equal(g.float().numpy() if t.dtype == torch.bfloat16
                                      else g.numpy(), want)
    assert not got[1][0, :2].any()  # out of range: zero rows


@pytest.mark.parametrize("idx_shape", [(5,), (5, 7)])
def test_int64_and_int32_idx_agree(idx_shape):
    rng = np.random.RandomState(3)
    arr = torch.from_numpy(rng.randint(-100, 100, (5, 11, 13)).astype(np.int8))
    meta = torch.from_numpy(rng.randint(-100, 100, (5, 11, 4)).astype(np.int32))
    idx = rng.randint(-2, 13, idx_shape)
    i32, i64 = torch.from_numpy(idx.astype(np.int32)), torch.from_numpy(idx)
    assert torch.equal(gather_rows(arr, i32), gather_rows(arr, i64))
    for x, y in zip(gather_rows_many((arr, meta), i32),
                    gather_rows_many((arr, meta), i64)):
        assert torch.equal(x, y)
    assert gather_rows_many((arr,), i64)[0].shape == gather_rows(arr, i64).shape


def test_gather_rows_many_rejects_bad_arguments():
    arr = torch.zeros(2, 3, 4)
    idx = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        gather_rows_many((), idx)
    with pytest.raises(ValueError):
        gather_rows_many((arr,) * (ops.MAX_ARENAS + 1), idx)
    with pytest.raises(ValueError):
        gather_rows_many((arr, torch.zeros(3, 3, 4)), idx)  # another B
    with pytest.raises(TypeError):
        gather_rows_many((arr,), idx.float())


# ---------------------------------------- the kernel's word plan, in numpy

def _u32(buf, addr):
    """Little-endian 32-bit words of ``buf`` at byte addresses ``addr``."""
    return sum(buf[addr + j].astype(np.uint64) << np.uint64(8 * j) for j in range(4))


def _width(L, src):
    """width_for of csrc/gather_rows.cu (the output base is 16-aligned)."""
    return next((w for w in (16, 8, 4) if L % w == 0 and src % w == 0),
                2 if L >= 16 else 1 if L >= 4 else 0)


def _funnel(lo, hi, sh):
    return (((hi << np.uint64(32)) | lo) >> (np.uint64(8) * sh)) & np.uint64(0xFFFFFFFF)


def _read_bytes(buf, a, n):
    """read_bytes: the n (1..4) bytes at addresses ``a`` as the low bytes of
    a word, from the aligned word at or below ``a`` and, only where the
    bytes reach into it, the next one; a funnel shift and a mask."""
    sh = (a & 3).astype(np.uint64)
    q = a - (a & 3)
    lo = _u32(buf, q)
    hi = np.where(sh + n > 4, _u32(buf, np.where(sh + n > 4, q + 4, q)), 0).astype(np.uint64)
    v = (((hi << np.uint64(32)) | lo) >> (np.uint64(8) * sh)) & np.uint64(0xFFFFFFFF)
    mask = (np.uint64(1) << (np.uint64(8) * np.minimum(n, 4).astype(np.uint64))) - np.uint64(1)
    return np.where(n >= 4, v, v & mask)


def _kernel_bytes(buf, src, N, L, idx):
    """What csrc/gather_rows.cu writes for one arena of ``L``-byte rows that
    starts at byte ``src`` of ``buf`` (an allocation whose start counts as
    aligned), chunk by chunk and word by word as its threads do: which output
    row and offset a chunk or word starts at, which aligned source words it
    reads from that row and the next, the shifts that put them in place, and
    the bytes of the last one that lie inside the output."""
    B, M = idx.shape
    rows = B * M
    total = rows * L
    flat = idx.reshape(-1).astype(np.int64)

    def source(r):  # byte address of output row r's source row, -1 if none
        i = np.where(r < rows, flat[np.minimum(r, rows - 1)], -1)
        ok = (i >= 0) & (i < N)
        return np.where(ok, src + ((r // M) * N + np.where(ok, i, 0)) * L, -1)

    width = _width(L, src)
    if width == 2:  # shift_chunk: 16 bytes, from row r or rows r and r + 1
        ob = np.arange(-(-total // 16)) * 16
        r = ob // L
        o = ob - r * L
        inside = o + 16 <= L
        row0 = source(r)
        row1 = np.where(~inside, source(r + 1), -1)
        a = np.where(inside & (row0 >= 0), row0 + o, 0)  # read only inside
        sh = (a & 3).astype(np.uint64)
        q = a - (a & 3)
        x = [_u32(buf, q + 4 * k) for k in range(4)]
        x.append(np.where(sh > 0, _u32(buf, np.where(sh > 0, q + 16, q)), 0).astype(np.uint64))
        words = []
        for k in range(4):
            in_row = np.where(row0 >= 0, _funnel(x[k], x[k + 1], sh), 0)
            ok = o + 4 * k
            n0 = np.clip(L - ok, 1, 4)
            head = np.where((ok < L) & (row0 >= 0),
                            _read_bytes(buf, np.maximum(row0, 0) + np.minimum(ok, L - 1), n0), 0)
            tail_n = np.where(ok < L, np.maximum(4 - n0, 1), 4)
            tail_at = np.maximum(row1, 0) + np.where(ok < L, 0, ok - L)
            tail = _read_bytes(buf, tail_at, tail_n)
            shift = np.where(ok < L, np.uint64(8) * n0.astype(np.uint64), np.uint64(0))
            use_tail = (row1 >= 0) & ((ok >= L) | (n0 < 4))
            across = (head | np.where(use_tail, tail << shift, 0)) & np.uint64(0xFFFFFFFF)
            words.append(np.where(inside, in_row, across))
        out = np.zeros(len(ob) * 16, np.uint8)
        for k in range(4):
            for j in range(4):
                out[ob + 4 * k + j] = (words[k] >> np.uint64(8 * j)) & np.uint64(0xFF)
        return out[:total]  # bytes past the end of the output are not stored
    if width > 2:  # copy_word<V>: one aligned word inside one row
        ob = np.arange(total // width) * width
        r = ob // L
        row = source(r)
        out = np.zeros(total, np.uint8)
        for j in range(width):
            out[ob + j] = np.where(row >= 0, buf[np.maximum(row, 0) + ob - r * L + j], 0)
        return out
    ob = np.arange(-(-total // 4)) * 4
    if width == 1:  # shift_word: the word's bytes from row r and row r + 1
        r = ob // L
        o = ob - r * L
        n0 = np.minimum(L - o, 4)
        row0 = source(r)
        row1 = np.where(n0 < 4, source(r + 1), -1)
        v = np.where(row0 >= 0, _read_bytes(buf, np.maximum(row0, 0) + o, n0), 0)
        n1 = np.maximum(4 - n0, 1)
        tail = _read_bytes(buf, np.maximum(row1, 0), n1) << (np.uint64(8) * n0.astype(np.uint64))
        v = (v | np.where(row1 >= 0, tail, 0)) & np.uint64(0xFFFFFFFF)
    else:  # byte_word: rows of 1 to 3 bytes
        v = np.zeros(len(ob), np.uint64)
        for j in range(4):
            bj = ob + j
            live = bj < total
            rj = np.where(live, bj // L, 0)
            rowj = source(rj)
            byte = np.where(live & (rowj >= 0),
                            buf[np.maximum(rowj, 0) + bj - rj * L], 0).astype(np.uint64)
            v |= byte << np.uint64(8 * j)
    out = np.zeros(len(ob) * 4, np.uint8)
    for j in range(4):
        out[ob + j] = (v >> np.uint64(8 * j)) & np.uint64(0xFF)
    return out[:total]  # the last word's bytes past the end are not stored


def test_word_plan_rebuilds_every_row_length():
    """Rows of 1 to 300 bytes from bases 0 to 3 bytes past alignment: the
    kernel's plan gives gather_rows_plain's bytes, zero rows included."""
    rng = np.random.RandomState(4)
    B, N, M = 3, 5, 4
    idx = rng.randint(-1, N + 1, (B, M))
    idx[0, 0], idx[1, 1] = -1, N
    for L in range(1, 301):
        arena = rng.randint(0, 256, (B, N, L)).astype(np.uint8)
        want = gather_rows_plain(torch.from_numpy(arena),
                                 torch.from_numpy(idx)).numpy().reshape(-1)
        for src in range(4):
            buf = np.zeros(src + arena.size + 8, np.uint8)  # a word past the end
            buf[src:src + arena.size] = arena.reshape(-1)
            np.testing.assert_array_equal(
                _kernel_bytes(buf, src, N, L, idx), want, err_msg=f"L={L} src={src}")


def test_off_the_cpu_the_wrappers_launch_one_kernel_and_never_cast(monkeypatch):
    """A tensor that is not on the CPU goes to one C call a wrapper call, with
    int64 indices as they lie and one descriptor an arena, and never to a
    plain version."""
    calls = []
    monkeypatch.setattr(ops, "_fns", SimpleNamespace(
        lib=None, one=lambda *a: calls.append(("one", a)) or 0,
        many=lambda *a: calls.append(("many", a)) or 0))
    monkeypatch.setattr(ops, "_check_card", lambda arr, what: None)
    monkeypatch.setattr(ops._build, "stream_of", lambda x: 0)

    def refuse(*args):
        raise AssertionError("a plain version was called")

    monkeypatch.setattr(ops, "gather_rows_plain", refuse)
    monkeypatch.setattr(ops, "gather_rows_many_plain", refuse)
    meta = dict(device="meta")
    B, N, W = 1024, 801, 16
    arenas = (torch.empty((B, N, 1), dtype=torch.bool, **meta),
              torch.empty((B, N, 32), dtype=torch.bfloat16, **meta),
              torch.empty((B, N, 32), dtype=torch.int32, **meta),
              torch.empty((B, N, 2), dtype=torch.float32, **meta),
              torch.empty((B, N, 225), dtype=torch.int8, **meta))
    idx = torch.empty((B, W), dtype=torch.int64, **meta)
    before = gather_rows.launches
    outs = gather_rows_many(arenas, idx)
    assert gather_rows.launches == before + 1 and [c[0] for c in calls] == ["many"]
    table, count, _, idx_bytes, b, m, _ = calls[0][1]
    assert (count, idx_bytes, b, m) == (5, 8, B, W)
    table = list(table)
    for k, (arr, out) in enumerate(zip(arenas, outs)):
        assert out.dtype == arr.dtype and out.shape == (B, W, arr.shape[2])
        src, dst, n, row_bytes = table[4 * k:4 * k + 4]
        assert (n, row_bytes) == (N, arr.shape[2] * arr.element_size())
        assert (src, dst) == (arr.data_ptr(), out.data_ptr())
    out = gather_rows(arenas[4], idx[:, 0])
    assert calls[1][0] == "one" and calls[1][1][2] == 8 and out.shape == (B, 225)
    assert gather_rows.launches == before + 2


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    for B, N, K, M, dt in [(1024, 801, 2, 512, torch.float32),
                           (1024, 801, 32, 16, torch.bfloat16),
                           (1024, 801, 225, 16, torch.int8),
                           (3, 7, 5, 4, torch.int32)]:
        arr = torch.randint(-100, 100, (B, N, K), device="cuda",
                            generator=g).to(dt)
        idx = torch.randint(-2, N + 2, (B, M), device="cuda", generator=g,
                            dtype=torch.int32)
        assert torch.equal(gather_rows(arr, idx), gather_rows_plain(arr, idx))
        assert torch.equal(gather_rows(arr, idx.long()), gather_rows_plain(arr, idx))
    for L in (1, 3, 7, 12, 225, 227):  # odd rows, also from a misaligned base
        raw = torch.randint(0, 255, (64 * 40 * L + 1,), device="cuda", generator=g,
                            dtype=torch.uint8)
        arr = raw[1:].view(64, 40, L).to(torch.int8)
        odd = raw[1:].view(torch.int8).view(64, 40, L)
        idx = torch.randint(-1, 41, (64, 9), device="cuda", generator=g,
                            dtype=torch.int32)
        for x in (arr, odd):
            assert torch.equal(gather_rows(x, idx), gather_rows_plain(x, idx))
    arenas = (arr > 0, arr, arr.to(torch.bfloat16), arr.float(), arr[:, :, :2].int())
    idx = torch.randint(-1, 41, (64, 9), device="cuda", generator=g)
    for x, y in zip(gather_rows_many(arenas, idx), gather_rows_many_plain(arenas, idx)):
        assert torch.equal(x, y)
