"""The plan of K1's and K13a's form sized to the rank (k <= 16,
``ops/normal_eq.small_form_plan``): which lane of a warp sums which
entries of which variant's system. The kernel reads the plan as it is
built here, so these tests check what the card runs: every entry of the
lower triangle of A (i >= j) and of b, for every variant, belongs to
exactly one lane of one warp of a group, and nothing else is kept.
"""

import numpy as np
import pytest

from predictionio_tpu_torch.ops import normal_eq as k1


def kept_entries(plan):
    """Each (variant, i, j) of A's lower triangle and (variant, i, "b") of
    b that the plan's lanes keep, read as the kernel reads a lane: units
    j0..j0+n-1 of row group ti, unit j < min(k, 4·ti + 4) the column j of
    rows 4·ti..4·ti+3 (kept where i < k and i >= j), unit min(k, 4·ti + 4)
    their b."""
    k = plan.k
    out = []
    for batch in range(plan.batches):
        v0 = batch * plan.VW
        for v, ti, j0, n in plan.lanes:
            if v0 + v >= plan.V:
                continue
            cmax = min(k, 4 * ti + 4)
            for j in range(j0, j0 + n):
                for i in range(4 * ti, min(k, 4 * ti + 4)):
                    if j == cmax:
                        out.append((v0 + v, i, "b"))
                    elif i >= j:
                        out.append((v0 + v, i, j))
    return out


@pytest.mark.parametrize("V", [1, 2, 3, 4])
@pytest.mark.parametrize("k", list(range(1, 17)))
def test_every_lower_entry_and_b_of_every_variant_has_one_lane(k, V):
    plan = k1.small_form_plan(k, V)
    got = kept_entries(plan)
    want = [(v, i, j) for v in range(V) for i in range(k) for j in range(i + 1)]
    want += [(v, i, "b") for v in range(V) for i in range(k)]
    assert len(got) == len(set(got)), "an entry belongs to two lanes"
    assert sorted(got, key=str) == sorted(want, key=str)
    kp = -(-k // 4) * 4
    assert plan.U in k1.SMALL_UNITS and plan.VW * kp <= 32 and len(plan.lanes) == 32
    assert plan.batches == -(-V // plan.VW)
    for v, ti, j0, n in plan.lanes:
        assert 0 <= n <= plan.U
        if n:
            assert v < plan.VW and 4 * ti < kp and j0 + n <= min(k, 4 * ti + 4) + 1
    # the cells the kernel takes decode to the lanes
    cells = np.frombuffer(plan.cells, np.int32)
    assert cells[0] == plan.U and cells[1] == plan.VW and len(cells) == 34
    assert [(c & 0xFF, c >> 8 & 0xFF, c >> 16 & 0xFF, c >> 24) for c in cells[2:]] == list(plan.lanes)


@pytest.mark.parametrize("k,V,U,VW", [(8, 1, 1, 1), (8, 2, 1, 2), (16, 1, 2, 1), (16, 2, 3, 2)])
def test_the_evaluation_grid_shapes_take_one_warp_and_few_units(k, V, U, VW):
    """The grid's ranks (8 and 16) with its two regularizers, and K1 at
    those ranks: a group's variants in one warp, U units a lane."""
    plan = k1.small_form_plan(k, V)
    assert (plan.U, plan.VW, plan.batches) == (U, VW, 1)


def test_the_plan_refuses_what_the_sized_form_does_not_take():
    for k, V in ((0, 1), (17, 1), (33, 2), (8, 0)):
        with pytest.raises(ValueError):
            k1.small_form_plan(k, V)
    assert k1.small_plan_address(17, 2) is None
    assert k1.small_plan_address(16, 2) == k1.small_form_plan(16, 2).cells.buffer_info()[0]
