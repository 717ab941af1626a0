"""The arithmetic of K1's warp-MMA form (17 <= k <= 32,
``csrc/normal_eq.cuh`` ``normal_eq_mma``; ``csrc/normal_eq.cu``'s header
gives the design), held on the CPU.

1. The split it rests on. A float32 x with |x| in [2^-110, 2^127], or 0,
   is exactly h + m + l, where h = bf16(x), m = bf16(x − h) and
   l = bf16(x − h − m), and both float32 differences are exact. The product
   of two bfloat16 values is exact in float32 and is exactly hi + lo,
   hi = bf16(p), lo = bf16(p − hi). Both facts are checked with no
   tolerance, by hypothesis and over a seeded sweep of bit patterns.
2. A plain-torch model of the form's sums (``mma_model``): the kernel's
   group plan (``ops/normal_eq.py plan_groups``), each group's segments
   walked in chunks of up to 32 slots. Each chunk's share of A is the sum of
   products of bfloat16 parts, formed in float32: float32 compute takes
   y = h + m + l and w_a·y the same way (fl(w_a·y) in implicit mode), with
   the six products l·h, h·l, m·m, m·h, h·m, h·h; bfloat16 compute takes
   y·y in explicit mode, and hi·y + lo·y, where w_a·y = hi + lo, in
   implicit mode. The chunk sums are added to float32 running sums in
   order, and a row of several groups sums its groups' partials in order.
   The model is held against the JAX package's ``_accumulate_systems``
   (the reference, on the CPU as ``tests/test_torch_normal_eq.py`` runs it)
   and the port's plain twin ``normal_eq_plain`` at k in {17, 24, 32},
   explicit and implicit, float32 and bfloat16. The tolerance is
   chip_smoke.py's K1_RTOL, 1e-4 of each row's scale (A: its largest
   diagonal entry; b: sqrt(Σ w_b² · that diagonal), the Cauchy-Schwarz
   bound of every Σ|w_b y_i|), plus 1e-6.

Inputs come from numpy seeds: 40 rows × 30 columns, 3,000 ratings, a tenth
of them dislikes (v < 0) in implicit mode. One row holds a third of the
ratings, so it spans two groups of 8 segments. One row has none. Segments
are 64 slots wide, so most are walked in two chunks. The twins run on one
torch thread, as in ``tests/test_torch_subspace_carry.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from predictionio_tpu.ops import als as jax_als
from predictionio_tpu_torch.ops import als as port_als
from predictionio_tpu_torch.ops import normal_eq as k1

K1_RTOL = 1e-4  # chip_smoke.py's, of the row's scale
ATOL = 1e-6
ALPHA = 0.7
N_ROWS, N_COLS, NNZ, L = 40, 30, 3_000, 64
HEAVY, EMPTY = 3, 7
LO, HI = 2.0 ** -110, 2.0 ** 127  # the split's exact range
MMA_RANKS = pytest.mark.parametrize("k", [17, 24, 32])
MODES = pytest.mark.parametrize("implicit", [False, True], ids=["explicit", "implicit"])
DTYPES = pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest bfloat16 (ties to even), as float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def split3(x: torch.Tensor):
    h = bf16(x)
    r = x - h
    m = bf16(r)
    return h, m, bf16(r - m)


def split2(x: torch.Tensor):
    h = bf16(x)
    return h, bf16(x - h)


# --- 1. the split ---


def _assert_split3_exact(x: np.ndarray) -> None:
    t = torch.from_numpy(x.astype(np.float32))
    h, m, l = split3(t)
    x64 = t.double()
    # both float32 differences exact, and the three parts sum to x
    assert torch.equal((t - h).double(), x64 - h.double())
    assert torch.equal((t - h - m).double(), x64 - h.double() - m.double())
    assert torch.equal(h.double() + m.double() + l.double(), x64)
    # each part a bfloat16
    for part in (h, m, l):
        assert torch.equal(bf16(part), part)


def _assert_split2_exact(w: np.ndarray, y: np.ndarray) -> None:
    wt, yt = bf16(torch.from_numpy(w.astype(np.float32))), bf16(torch.from_numpy(y.astype(np.float32)))
    p = wt * yt
    assert torch.equal(p.double(), wt.double() * yt.double())  # the product is exact
    hi, lo = split2(p)
    assert torch.equal(hi.double() + lo.double(), p.double())
    assert torch.equal(bf16(lo), lo)


finite32 = st.floats(min_value=LO, max_value=HI, width=32)


@settings(max_examples=400, deadline=None, derandomize=True)
@given(st.lists(st.tuples(finite32, st.booleans()), min_size=1, max_size=64))
def test_every_float32_in_range_is_three_bfloat16_parts(xs):
    x = np.array([v if neg else -v for v, neg in xs] + [0.0], np.float32)
    _assert_split3_exact(x)


moderate = st.floats(min_value=2.0 ** -50, max_value=2.0 ** 50, width=32)


@settings(max_examples=400, deadline=None, derandomize=True)
@given(st.lists(st.tuples(moderate, moderate, st.booleans()), min_size=1, max_size=64))
def test_a_bfloat16_product_is_two_bfloat16_parts(triples):
    w = np.array([t[0] for t in triples] + [0.0], np.float32)
    y = np.array([t[1] if t[2] else -t[1] for t in triples] + [1.5], np.float32)
    _assert_split2_exact(w, y)


@pytest.mark.parametrize("lo_exp,hi_exp", [(-110, -60), (-60, -10), (-10, 10), (10, 126)])
def test_split3_over_seeded_bit_patterns(lo_exp, hi_exp):
    """200,000 float32 values with every mantissa pattern equally likely,
    exponents uniform in [lo_exp, hi_exp], both signs, and the range's ends."""
    rng = np.random.default_rng(lo_exp + 1000)
    n = 200_000
    mant = rng.integers(0, 1 << 23, n, dtype=np.uint32)
    exp = rng.integers(lo_exp + 127, hi_exp + 127, n, dtype=np.uint32)
    sign = rng.integers(0, 2, n, dtype=np.uint32) << 31
    x = (sign | exp << 23 | mant).view(np.float32)
    ends = np.array([LO, -LO, HI, -HI, np.nextafter(np.float32(HI), np.float32(0))], np.float32)
    _assert_split3_exact(np.concatenate([x, ends]))


def test_split2_over_seeded_ratings_and_factors():
    """The implicit weights bf16(α|v|) of ratings on the half-step grid and
    off it, against standard-normal factors rounded to bfloat16."""
    rng = np.random.default_rng(3)
    v = np.concatenate([rng.integers(-10, 11, 50_000) / 2, rng.uniform(-5, 5, 50_000)])
    w = np.abs(ALPHA * v)
    y = rng.standard_normal(len(w)) * np.exp(rng.uniform(-8, 8, len(w)))
    _assert_split2_exact(w, y)


# --- 2. the form's sums ---


@pytest.fixture(scope="module")
def sides():
    out = {}
    for implicit in (False, True):
        rng = np.random.default_rng(11)
        u = rng.integers(0, N_ROWS, NNZ).astype(np.int32)
        u[: NNZ // 3] = HEAVY  # two groups of segments: partials and a combine
        u[u == EMPTY] = EMPTY + 1
        i = rng.integers(0, N_COLS, NNZ).astype(np.int32)
        r = (rng.integers(1, 11, NNZ) / 2 + 0.2).astype(np.float32)  # off the bfloat16 grid too
        if implicit:
            r[rng.random(NNZ) < 0.1] *= -1
        out[implicit] = port_als.pack_segments(u, i, r, N_ROWS, L, 1, 1024)
    return out


def _weights(v: torch.Tensor, implicit: bool, bf: bool):
    """(w_a, w_b) of the slots' ratings in the compute type."""
    rnd = bf16 if bf else (lambda t: t)
    if implicit:
        conf = ALPHA * v.abs()
        return rnd(conf), rnd(torch.where(v > 0, 1.0 + conf, torch.zeros_like(v)))
    return torch.ones_like(v), rnd(v)


def _chunk_sum(y: torch.Tensor, w_a: torch.Tensor, implicit: bool, bf: bool) -> torch.Tensor:
    """One chunk's share of A, [k, k]: its slots' products of bfloat16 parts,
    summed in float32."""
    def prod(a, b_):
        return a.T @ b_

    if bf:
        if not implicit:
            return prod(y, y)
        hi, lo = split2(w_a[:, None] * y)
        return prod(lo, y) + prod(hi, y)
    yb = split3(y)
    ya = split3(w_a[:, None] * y) if implicit else yb
    total = torch.zeros((y.shape[1], y.shape[1]), dtype=torch.float32)
    for pa, pb in ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0)):
        total = total + prod(ya[pa], yb[pb])
    return total


def mma_model(Y: np.ndarray, side, R: int, implicit: bool, compute_dtype: str):
    """A [R, k, k] and b [R, k] as the warp-MMA form sums them (see the
    module docstring)."""
    bf = compute_dtype == "bfloat16"
    Yt = torch.from_numpy(Y)
    if bf:
        Yt = bf16(Yt)
    k = Yt.shape[1]
    seg_rows = side.seg_rows.reshape(-1)
    rem = side.rem.reshape(-1)
    cols = torch.from_numpy(side.cols.reshape(len(rem), -1).astype(np.int64))
    vals = torch.from_numpy(side.vals.reshape(len(rem), -1))
    groups, c_rows, c_start, n_partials = k1.plan_groups(seg_rows, rem, R)
    A = torch.zeros((R, k, k), dtype=torch.float32)
    b = torch.zeros((R, k), dtype=torch.float32)
    partials = torch.zeros((max(n_partials, 1), k * k + k), dtype=torch.float32)
    for row, seg0, nseg, slot in groups.T:
        a_run = torch.zeros((k, k), dtype=torch.float32)
        b_run = torch.zeros(k, dtype=torch.float32)
        for s in range(seg0, seg0 + nseg):
            for l0 in range(0, int(rem[s]), 32):
                c = min(32, int(rem[s]) - l0)
                y = Yt[cols[s, l0:l0 + c]]
                w_a, w_b = _weights(vals[s, l0:l0 + c], implicit, bf)
                a_run = a_run + _chunk_sum(y, w_a, implicit, bf)
                for q in range(c):  # b: the float32 chain over the slots in order
                    b_run = b_run + w_b[q] * y[q]
        if slot < 0:
            A[row], b[row] = a_run, b_run
        else:
            partials[slot] = torch.cat([a_run.reshape(-1), b_run])
    for m, row in enumerate(c_rows):
        total = torch.zeros(k * k + k, dtype=torch.float32)
        for p in range(c_start[m], c_start[m + 1]):
            total = total + partials[p]
        A[row], b[row] = total[: k * k].reshape(k, k), total[k * k:]
    return A.numpy(), b.numpy()


def _assert_within_k1_rtol(side, implicit, A, b, A_ref, b_ref):
    diag = np.diagonal(A_ref, axis1=1, axis2=2).max(axis=1)
    v = side.vals
    w_b = np.where(v > 0, 1.0 + ALPHA * np.abs(v), 0.0) if implicit else v
    vsq = np.bincount(side.seg_rows.reshape(-1), weights=np.square(w_b).sum(-1).reshape(-1),
                      minlength=len(b))[: len(b)]
    np.testing.assert_array_less(np.abs(A - A_ref).max(axis=(1, 2)), ATOL + K1_RTOL * diag)
    np.testing.assert_array_less(np.abs(b - b_ref).max(axis=1),
                                 ATOL + K1_RTOL * np.sqrt(vsq * diag))


@MMA_RANKS
@MODES
@DTYPES
def test_mma_model_matches_jax_accumulate_systems_and_the_twin(sides, k, implicit, compute_dtype):
    side = sides[implicit]
    R, n_y = port_als._padded_rows(N_ROWS, 1), port_als._padded_rows(N_COLS, 1)
    Y = np.random.default_rng(100 + k).standard_normal((n_y, k)).astype(np.float32)
    plan = k1.plan_groups(side.seg_rows.reshape(-1), side.rem.reshape(-1), R)
    assert plan[3] > 0 and (side.rem > 32).any()  # a combined row; two-chunk segments
    A, b = mma_model(Y, side, R, implicit, compute_dtype)
    A_ref, b_ref = jax_als._accumulate_systems(
        jnp.asarray(Y), jnp.asarray(side.seg_rows), jnp.asarray(side.cols),
        jnp.asarray(side.vals), jnp.asarray(side.rem), ALPHA, R,
        implicit=implicit, compute_dtype=compute_dtype,
    )
    _assert_within_k1_rtol(side, implicit, A, b, np.asarray(A_ref), np.asarray(b_ref))
    pack = port_als.device_pack(side, R, n_y, torch.device("cpu"))
    A2, b2 = k1.normal_eq_plain(torch.from_numpy(Y), pack.seg_rows, pack.cols, pack.vals,
                                pack.rem, R, implicit, ALPHA, compute_dtype)
    _assert_within_k1_rtol(side, implicit, A, b, A2.numpy(), b2.numpy())
    assert not A[EMPTY].any() and not b[EMPTY].any()


@pytest.mark.parametrize("shape", [(50, 17), (50, 24), (3, 50, 31), (50, 32)])
def test_bf16_rows_round_once_and_pad_to_16_bytes(shape):
    Y = torch.from_numpy(np.random.default_rng(1).standard_normal(shape).astype(np.float32))
    Yh = k1.bf16_rows(Y)
    k, kh = shape[-1], -(-shape[-1] // 8) * 8
    assert Yh.dtype == torch.bfloat16 and Yh.shape == (*shape[:-1], kh) and Yh.is_contiguous()
    assert torch.equal(Yh[..., :k], Y.to(torch.bfloat16))
    assert not Yh[..., k:].any()


@pytest.mark.parametrize("k", [8, 16, 33])
def test_bf16_rows_only_for_the_mma_ranks(k):
    assert k1.bf16_rows(torch.zeros((4, k))) is None
