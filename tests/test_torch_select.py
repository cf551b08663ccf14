"""The whole-level kernel's robust median and its cluster sum order, on the
CPU, against the plain version it is held to on the card.

* The kernel selects the median's two ranks exactly (a radix select over
  order-preserving uint32 keys) and replays the reference's 24 value-domain
  bisection steps against the selected values. `_select_replay` below is
  that algorithm in numpy float32 (a sort of the keys stands for the radix
  select, which finds the same k-th key); it must equal the counting
  bisection `fused_solve._bisect_median` bit for bit, for ties, all-equal
  sets, -0.0 / +0.0, NaN and infinite values, n other than the mask count,
  n = 0, one point and wide ranges.
* `fused_solve._block_sum(..., ctas=C)`: C blocks each summing a
  contiguous share of 16 ceil(P / 16 C) points in the single-block order,
  then added in block order. C = 1 is bit-equal to the single-block order
  (the order kernel 3's plain twin keeps); every C is bit-equal to a
  loop-by-loop model of the kernel's order and within 1e-5 relative of a
  float64 sum.
"""

import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from vslam_tpu_torch.alignment import fused_solve
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

STEPS = 24


def _keys(x: np.ndarray) -> np.ndarray:
    """Order-preserving uint32 keys of non-NaN float32 values (the kernel's
    `float_key`: -0 just below +0)."""
    u = x.astype(np.float32).view(np.uint32)
    return np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000)).astype(np.uint32)


def _key_values(k: np.ndarray) -> np.ndarray:
    u = np.where(k & np.uint32(0x80000000), k & np.uint32(0x7FFFFFFF), ~k).astype(np.uint32)
    return u.view(np.float32)


def _select_replay(v: np.ndarray, m: np.ndarray, n: float) -> np.float32:
    """The kernel's median of one row: select ranks k_lo and k_hi of the
    masked non-NaN values exactly, then replay 24 bisection steps of the
    [min, max] bracket against each (a rank beyond the values never
    satisfies the count), average; 0 when n <= 0. All in float32. The
    bracket is the masked min and max with NaN propagating (a NaN leaves
    the set empty, as jnp.min does in the reference), which the kernel
    computes as the plain version does."""
    f32 = np.float32
    vals = v[m & ~np.isnan(v)].astype(np.float32)
    keys = np.sort(_keys(vals))
    n = f32(n)
    k_lo = max(np.floor((n - f32(1.0)) * f32(0.5)), f32(0.0))
    k_hi = max(np.floor(n * f32(0.5)), f32(0.0))
    tv, tm = torch.as_tensor(v), torch.as_tensor(m)
    mn = f32(torch.where(tm, tv, torch.tensor(np.inf)).amin().item())
    mx = f32(torch.where(tm, tv, torch.tensor(-np.inf)).amax().item())
    empty = not (mx >= mn)
    his = []
    for k in (int(k_lo), int(k_hi)):
        exists = k < keys.size
        vk = _key_values(keys[k:k + 1])[0] if exists else f32(np.inf)
        lo, hi = (f32(0.0), f32(0.0)) if empty else (f32(mn), f32(mx))
        for _ in range(STEPS):
            with np.errstate(invalid="ignore"):  # -inf + inf, as on the card
                mid = f32(0.5) * (lo + hi)
            if exists and vk <= mid:
                hi = mid
            else:
                lo = mid
        his.append(hi)
    return f32(0.5) * (his[0] + his[1]) if n > 0 else f32(0.0)


_SPECIAL = [0.0, -0.0, 1.0, -1.0, float("nan"), float("inf"), float("-inf"), 1e-30, -1e30, 3.0]
_values = st.one_of(
    st.sampled_from(_SPECIAL),
    st.integers(-3, 3).map(float),  # ties
    st.floats(-1e6, 1e6, width=32),
    st.floats(width=32, allow_nan=True, allow_infinity=True),  # wide ranges
)


@st.composite
def _rows(draw):
    P = draw(st.integers(1, 40))
    v = np.asarray(draw(st.lists(_values, min_size=P, max_size=P)), np.float32)
    if draw(st.booleans()):
        v[:] = v[0]  # all equal
    m = np.asarray(draw(st.lists(st.booleans(), min_size=P, max_size=P)))
    count = int(m.sum())
    n = draw(st.one_of(st.just(count), st.integers(0, P + 3)))  # the mask count, or not
    return v, m, float(n)


def _bits(x) -> int:
    return int(np.asarray(x, np.float32).view(np.int32))


@settings(max_examples=300, deadline=None)
@given(_rows())
@example((np.array([2.0, 2.0, 2.0], np.float32), np.array([True, True, True]), 3.0))
@example((np.array([-0.0, 0.0, -0.0, 0.0], np.float32), np.array([True] * 4), 4.0))
@example((np.array([np.nan, 1.0, np.nan], np.float32), np.array([True] * 3), 3.0))
@example((np.array([5.0], np.float32), np.array([True]), 1.0))
@example((np.array([1.0, 2.0], np.float32), np.array([True, True]), 0.0))
@example((np.array([1.0, np.inf, np.inf], np.float32), np.array([True] * 3), 3.0))
@example((np.array([-np.inf, 1.0, np.inf], np.float32), np.array([True] * 3), 3.0))
@example((np.array([1.0, 2.0, 3.0], np.float32), np.array([False] * 3), 2.0))
@example((np.array([-1e30, 1e-30, 7.0, 1e30], np.float32), np.array([True] * 4), 9.0))
def test_select_then_replay_equals_the_counting_bisection(row):
    """Tolerance: none, the two must agree bit for bit."""
    v, m, n = row
    want = fused_solve._bisect_median(torch.as_tensor(v)[None, None], torch.as_tensor(m)[None, None],
                                      torch.tensor([[n]], dtype=torch.float32))[0, 0]
    got = _select_replay(v, m, n)
    assert _bits(got) == _bits(want.numpy()), (got, want, v, m, n)


def _kernel_order_sum(x: np.ndarray, ctas: int) -> np.float32:
    """The whole-level kernel's sum of x (P,) on ``ctas`` blocks, loop by
    loop in float32: block c takes points [c S, (c + 1) S), S = 16
    ceil(P / 16 ctas); thread t adds its points t, t + 256, ... in turn;
    each warp a shuffle-down tree; the 8 warps in sequence; the blocks in
    rank order."""
    P = x.size
    S = -(-P // (16 * ctas)) * 16
    total = None
    for c in range(ctas):
        share = x[c * S:min(P, (c + 1) * S)]
        acc = np.zeros(256, np.float32)
        for t in range(256):
            pts = share[t::256]
            if pts.size:
                a = pts[0]
                for p in pts[1:]:
                    a = np.float32(a + p)
                acc[t] = a
        warps = acc.reshape(8, 32)
        o = 16
        while o:
            warps = warps[:, :o] + warps[:, o:2 * o]
            o //= 2
        block = warps[0, 0]
        for w in range(1, 8):
            block = np.float32(block + warps[w, 0])
        total = block if total is None else np.float32(total + block)
    return total


@pytest.mark.parametrize("P", [300, 1927, 4099])
@pytest.mark.parametrize("ctas", [1, 2, 4, 8])
def test_block_sum_over_ctas_follows_the_kernel_order(P, ctas):
    """Bit for bit with the loop model; within 1e-5 relative of float64 (a
    sum of positive values of depth ~40 additions in float32)."""
    x = np.random.default_rng(P + ctas).uniform(0.5, 2.0, P).astype(np.float32)
    got = fused_solve._block_sum(torch.as_tensor(x)[:, None], ctas=ctas)[0]
    assert _bits(got.numpy()) == _bits(_kernel_order_sum(x, ctas))
    exact = x.astype(np.float64).sum()
    assert abs(float(got) - exact) <= 1e-5 * exact
    if ctas == 1:
        assert _bits(got.numpy()) == _bits(fused_solve._block_sum(torch.as_tensor(x)[:, None])[0].numpy())


def test_block_sum_over_ctas_keeps_leading_axes():
    """(B, F, P, K) sums to (B, F, K), each row in the kernel's order."""
    x = np.random.default_rng(3).uniform(0.5, 2.0, (2, 3, 700, 4)).astype(np.float32)
    got = fused_solve._block_sum(torch.as_tensor(x), ctas=4)
    for b in range(2):
        for f in range(3):
            for k in range(4):
                assert _bits(got[b, f, k].numpy()) == _bits(_kernel_order_sum(x[b, f, :, k], 4))
