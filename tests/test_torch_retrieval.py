"""The port's retriever (``ops/retrieval.py``) and its kernels' plain twins
(``ops/masked_topn.py``: kernel A, the candidate mask and the masked
top-m; ``ops/rescore.py``: kernel B, the exact rescore) against the JAX
package's ``ops/retrieval.py`` on the same seeded numpy inputs, on the
CPU (``device="cpu"``).

Catalog: the bench's quantized-catalog generator (``bench.py:3044``) at
2,000 items and rank 16, plus tiny edge catalogs.

Tolerances:
- quantization, int8 stage-1 scores and ids: bit for bit (the int8 sums
  are exact integers; the epilogue multiplies in the same order);
- float32 and bf16 scores rtol 1e-5 / atol 1e-6 (XLA and PyTorch sum the
  rank in different orders; bf16 products are exact in f32), ids equal
  outside near-tie runs (``check_topn_agreement``);
- the retriever's quantized answers are refined on the host against the
  original rows with the reference's own numpy code, so they are held to
  the same tolerance as float32;
- recall@n >= 0.999 against ``naive_topn_reference``, the bench's gate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import retrieval as jret
from predictionio_tpu_torch.ops import masked_topn as ka
from predictionio_tpu_torch.ops import rescore as kb
from predictionio_tpu_torch.ops import retrieval as pret
from predictionio_tpu_torch.ops.topn import check_topn_agreement

RTOL, ATOL = 1e-5, 1e-6
N_ITEMS, RANK = 2000, 16
FLAGS = [(False, False), (True, False), (True, True)]
PRECISIONS = ["float32", "bf16", "int8"]


def catalog(n_items=N_ITEMS, rank=RANK, seed=37):
    """The bench's quantized catalog: clustered rows, so near-duplicates
    crowd the top-n boundary."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((256, rank)).astype(np.float32)
    return (
        base[rng.integers(0, 256, n_items)]
        + 0.3 * rng.standard_normal((n_items, rank))
    ).astype(np.float32)


@pytest.fixture(scope="module")
def Y():
    return catalog()


def masks(rng, B, n_items):
    """Per-query exclude lists (widths 1..64) and include lists, one of
    them empty (no candidates) and one None (unrestricted)."""
    exclude = [rng.choice(n_items, size=w, replace=False) for w in rng.integers(1, 65, B)]
    include = [None] * B
    include[1] = np.sort(rng.choice(n_items, size=300, replace=False))
    include[2] = np.zeros(0, np.int64)
    include[3] = np.arange(10)  # fewer live candidates than n
    return exclude, include


def check_answer(ps, pi, js, ji, rtol=RTOL, atol=ATOL):
    """The port's (scores, ids) against JAX's: the same live slots, the
    live prefix within tolerance, the dead (-inf) slots' ids equal."""
    live = np.isfinite(js)
    np.testing.assert_array_equal(np.isfinite(ps), live)
    np.testing.assert_array_equal(np.where(live, 0, pi), np.where(live, 0, ji))
    for r in range(js.shape[0]):
        k = int(live[r].sum())
        if k:
            check_topn_agreement(ps[r:r + 1, :k], pi[r:r + 1, :k], js[r:r + 1, :k],
                                 ji[r:r + 1, :k], rtol, atol)


def test_quantization_matches_jax_bit_for_bit(Y):
    Yz = np.concatenate([Y[:50], np.zeros((3, RANK), np.float32)])
    qj, sj = jret.quantize_rows_int8(Yz)
    qp, sp = pret.quantize_rows_int8(Yz)
    np.testing.assert_array_equal(qp, qj)
    np.testing.assert_array_equal(sp.view(np.uint32), sj.view(np.uint32))
    np.testing.assert_array_equal(
        pret.dequantize_rows_int8(qp, sp).view(np.uint32),
        jret.dequantize_rows_int8(qj, sj).view(np.uint32),
    )
    np.testing.assert_array_equal(
        pret._reciprocal_norms(Yz).view(np.uint32),
        jret._reciprocal_norms(Yz).view(np.uint32),
    )
    for prec in PRECISIONS:
        jr = jret.ItemRetriever(Yz, precision=prec)
        pr = pret.ItemRetriever(Yz, precision=prec, device="cpu")
        np.testing.assert_array_equal(
            pr.dequantized_factors().view(np.uint32),
            jr.dequantized_factors().view(np.uint32),
        )
        assert pr.resident_bytes == jr.resident_bytes
        jr.free()


def _device_inputs(r, q, exclude, include):
    """A port retriever's device operands for one batch, as topn builds
    them."""
    b = q.shape[0]
    excl, _ = r._assemble_idx(list(exclude), b)
    incl, has = r._assemble_idx(list(include), b)
    return excl, incl, has


def _jax_stage1(jr, q, excl, incl, has, m, positive_only, normalize):
    scores = (
        jnp.dot(q, jr._y_dev.T, preferred_element_type=jnp.float32)
        if jr.precision == "float32"
        else jret._approx_scores(q, jr._y_dev, jr._scale_operand, jr.precision)
    )
    if normalize:
        scores = scores * jr._rn_dev[None, :]
    scores = jret._mask_scores(scores, jr._allow_dev, excl, incl, has, positive_only)
    s1, i1 = jax.lax.top_k(scores, m)
    return np.asarray(s1), np.asarray(i1)


@pytest.mark.parametrize("prec", PRECISIONS)
@pytest.mark.parametrize("positive_only,normalize", FLAGS)
def test_kernel_twins_match_jax_stages(Y, prec, positive_only, normalize):
    """Kernel A's twin against the reference's masked score + top_k (the
    stage-1 shortlist of _fused_topn_single_2s, or _fused_topn_single's
    output), kernel B's twin against _rescore_exact + top_k on the same
    shortlist."""
    rng = np.random.default_rng(11)
    B, n = 8, 16
    q = rng.standard_normal((B, RANK)).astype(np.float32)
    exclude, include = masks(rng, B, N_ITEMS)
    jr = jret.ItemRetriever(Y, precision=prec)
    pr = pret.ItemRetriever(Y, precision=prec, device="cpu")
    resident = rng.choice(N_ITEMS, size=40, replace=False)
    jr.set_excluded_ids(resident)
    pr.set_excluded_ids(resident)
    excl, incl, has = _device_inputs(pr, q, exclude, include)
    n_dev = n if prec == "float32" else pr._shortlist_width(n, N_ITEMS)
    m = n if prec == "float32" else pr._shortlist_width(n_dev, N_ITEMS)
    assert (n_dev, m) == ((16, 16) if prec == "float32" else (64, 256))

    t = torch.from_numpy
    bits = ka.candidate_mask(pr._allow_dev, t(excl), t(incl), t(has))
    ref_allow = np.asarray(jret._mask_scores(
        jnp.zeros((B, N_ITEMS)), jr._allow_dev, excl, incl, has, False)) == 0
    np.testing.assert_array_equal(ka.unpack_bits(bits, N_ITEMS).numpy(), ref_allow)
    rn = pr._rn_dev if normalize else None
    stage1 = ka.masked_topn_packed(
        t(q), pr._y_dev, pr._scale_dev, rn, bits, m, positive_only, normalize)
    ps, pi = pret.unpack_topn(stage1.numpy(), m)
    js, ji = _jax_stage1(jr, q, excl, incl, has, m, positive_only, normalize)
    if prec == "int8":
        np.testing.assert_array_equal(ps.view(np.uint32), js.view(np.uint32))
        np.testing.assert_array_equal(pi, ji)
    else:
        check_answer(ps, pi, js, ji)
    if prec == "float32":
        fused = np.asarray(jret._fused_topn_single(
            q, jr._y_dev, jr._rn_dev, jr._allow_dev, excl, incl, has,
            n, positive_only, normalize))
        fs, fi = jret.unpack_topn(fused, n)
        check_answer(ps, pi, fs, fi)
        jr.free()
        return

    # stage 2 on the same shortlist: JAX's on its own, the port's on its
    # own (bit-equal for int8, so the same shortlist)
    packed = kb.rescore_topn(
        t(q), pr._y_dev, pr._scale_dev, rn, stage1, n_dev, positive_only, normalize)
    s2, i2 = pret.unpack_topn(packed.numpy(), n_dev)
    rescored = jret._rescore_exact(
        q, jr._y_dev, jr._scale_operand, js, ji, jr._rn_dev, positive_only,
        normalize, prec)
    rs, j = jax.lax.top_k(rescored, n_dev)
    rs, ri = np.asarray(rs), np.take_along_axis(ji, np.asarray(j), axis=1)
    check_answer(s2, i2, rs, ri)
    # and the reference's fused two-stage program, both stages in one
    fused = np.asarray(jret._fused_topn_single_2s(
        q, jr._y_dev, jr._scale_operand, jr._rn_dev, jr._allow_dev,
        excl, incl, has, n_dev, m, positive_only, normalize, prec))
    check_answer(s2, i2, *jret.unpack_topn(fused, n_dev))
    jr.free()


@pytest.mark.parametrize("prec", PRECISIONS)
@pytest.mark.parametrize("positive_only,normalize", FLAGS)
def test_item_retriever_topn_matches_jax(Y, prec, positive_only, normalize):
    rng = np.random.default_rng(12)
    B = 12  # padded to 16 rows, as the reference pads
    q = rng.standard_normal((B, RANK)).astype(np.float32)
    q[5] = 0.0  # a zero query row: every item scores 0
    exclude, include = masks(rng, B, N_ITEMS)
    jr = jret.ItemRetriever(Y, precision=prec)
    pr = pret.ItemRetriever(Y, precision=prec, device="cpu")
    resident = rng.choice(N_ITEMS, size=500, replace=False)
    assert jr.set_excluded_ids(resident) and pr.set_excluded_ids(resident)
    assert not pr.set_excluded_ids(resident)
    for n in (1, 10, 16, 40):
        js, ji = jr.topn(q, n, exclude=exclude, include=include,
                         positive_only=positive_only, normalize=normalize)
        ps, pi = pr.topn(q, n, exclude=exclude, include=include,
                         positive_only=positive_only, normalize=normalize)
        check_answer(ps, pi, js, ji)
        assert not np.isfinite(ps[2]).any()  # the empty include: no candidates
        assert np.isfinite(ps[3]).sum() <= 10  # k > live candidates
    jr.free()


@pytest.mark.parametrize("prec", PRECISIONS)
def test_edge_catalogs_match_jax(prec):
    """A ragged catalog smaller than the shortlist, exact ties from
    duplicated rows (the lowest id wins), and zero query rows (items
    0..n-1)."""
    rng = np.random.default_rng(13)
    ties = rng.integers(-3, 4, size=(20, 4)).astype(np.float32)
    cases = [
        ("ragged", catalog(40, 6, seed=3), 16),
        ("ties", np.concatenate([ties, ties, ties[:7]]), 30),
    ]
    for name, Yc, n in cases:
        N = Yc.shape[0]
        q = rng.integers(-3, 4, size=(9, Yc.shape[1])).astype(np.float32)
        q[0] = 0.0
        jr = jret.ItemRetriever(Yc, precision=prec)
        pr = pret.ItemRetriever(Yc, precision=prec, device="cpu")
        for positive_only, normalize in FLAGS:
            js, ji = jr.topn(q, n, positive_only=positive_only, normalize=normalize)
            ps, pi = pr.topn(q, n, positive_only=positive_only, normalize=normalize)
            check_answer(ps, pi, js, ji)
            if not positive_only:
                np.testing.assert_array_equal(pi[0], np.arange(n))
        if name == "ties":
            # duplicated rows score alike: the lowest id comes first
            ps, pi = pr.topn(q, N)
            for r in range(1, q.shape[0]):
                for a in range(N - 1):
                    if ps[r, a] == ps[r, a + 1]:
                        assert pi[r, a] < pi[r, a + 1], (name, r, a)
        jr.free()


@pytest.mark.parametrize("prec", ["bf16", "int8"])
def test_recall_and_exact_scores_against_naive_reference(Y, prec):
    """The bench's gates, at 2,000 items: recall@10 >= 0.999 against the
    naive full-matrix top-n, every returned score the exact f32 dot of its
    id's original row, and the resident bytes reduced (>= 3x for int8 at
    rank 64)."""
    rng = np.random.default_rng(14)
    exact = pret.ItemRetriever(Y, device="cpu")
    quant = pret.ItemRetriever(Y, precision=prec, device="cpu")
    hits = total = 0
    for _ in range(4):
        q = rng.standard_normal((64, RANK)).astype(np.float32)
        _, ref_i = jret.naive_topn_reference(Y, q, 10)
        qs, qi = quant.topn(q, 10)
        hits += sum(len(set(a) & set(b)) for a, b in zip(qi.tolist(), ref_i.tolist()))
        total += qi.size
        np.testing.assert_allclose(
            qs, np.einsum("bk,bnk->bn", q, Y[qi]), rtol=1e-5, atol=1e-5)
    assert hits / total >= 0.999
    # the bytes gate at the bench's rank, 64 (at rank 16 the per-row
    # norm, scale and mask bytes weigh more)
    Y64 = catalog(200, 64)
    reduction = (pret.ItemRetriever(Y64, device="cpu").resident_bytes
                 / pret.ItemRetriever(Y64, precision=prec, device="cpu").resident_bytes)
    assert reduction >= (3.0 if prec == "int8" else 1.9)


def test_twins_refuse_what_the_kernels_refuse(Y):
    t = torch.from_numpy
    q = t(np.ones((2, RANK), np.float32))
    bits = torch.zeros((2, ka.mask_words(N_ITEMS)), dtype=torch.int32)
    with pytest.raises(ValueError, match="scale"):
        ka.masked_topn_packed(q, t(Y).to(torch.int8), None, None, bits, 4)
    with pytest.raises(ValueError, match="m="):
        ka.masked_topn_packed(q, t(Y), None, None, bits, N_ITEMS + 1)
    with pytest.raises(ValueError, match="rn"):
        ka.masked_topn_packed(q, t(Y), None, None, bits, 4, normalize=True)
    stage1 = torch.zeros((2, 8), dtype=torch.float32)
    with pytest.raises(ValueError, match="n_out"):
        kb.rescore_topn(q, t(Y).to(torch.bfloat16), None, None, stage1, 5)
    with pytest.raises(TypeError, match="Mesh"):
        pret.ItemRetriever(Y, mesh=object(), device="cpu")
    r = pret.ItemRetriever(Y, precision="int8", device="cpu")
    r.free()
    with pytest.raises(RuntimeError, match="freed"):
        r.topn(np.ones((1, RANK), np.float32), 3)


def test_host_helpers_match_jax():
    class It:
        def __init__(self, cats):
            self.categories = cats

    items = {0: It(("a", "b")), 1: It(()), 2: It(("b",)), 3: It(("c", "a"))}
    pj, pp = jret.build_category_index(items), pret.build_category_index(items)
    assert pj.keys() == pp.keys()
    for c in pj:
        np.testing.assert_array_equal(pp[c], pj[c])
    index = {"x": 0, "y": 2, "z": 3}
    for wl, cats in [(None, None), (["x", "z", "nope"], None), (None, ["a"]),
                     (["x", "y"], ["b"]), ([], ["a"]), (None, ["zzz"])]:
        a = jret.include_candidates(index, wl, cats, lambda c: jret.category_candidates(pj, c))
        b = pret.include_candidates(index, wl, cats, lambda c: pret.category_candidates(pp, c))
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(b, a)
    s = np.array([[3.0, 2.0, -np.inf], [1.0, -np.inf, -np.inf]], np.float32)
    i = np.array([[4, 5, 6], [7, 8, 9]], np.int32)
    for (aj, bj), (ap, bp) in zip(jret.trimmed_results(s, i, [2, 3]),
                                  pret.trimmed_results(s, i, [2, 3])):
        np.testing.assert_array_equal(ap, aj)
        np.testing.assert_array_equal(bp, bj)


def test_warm_runs_one_batch_per_flag_combo(Y):
    """The kernels take any shape once loaded, so warm runs one top-n
    batch per flag combo, whatever the batch and exclude-width ladders."""
    r = pret.ItemRetriever(Y, precision="int8", device="cpu")
    ka.LAUNCHES.reset()
    kb.LAUNCHES.reset()
    r.warm(n=64, max_batch=128, flag_combos=((False, False), (True, True)),
           exclude_widths=(1, 16, 64))
    assert ka.LAUNCHES.snapshot()["masked_topn_plain"] == 2
    assert kb.LAUNCHES.snapshot()["rescore_topn_plain"] == 2
    r.free()
