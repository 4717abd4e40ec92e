"""The plan of the plant kernel's sums (``sim/contact.py`` ``piece_tables``).

The kernel P1 sums each object's contact forces across lanes: a segmented
scan over each *piece* (a run of slots of one object and surface inside one
warp of 32), whose first lane writes the sum to a row of the object and, for
a surface on another object, the reaction to a row of that object; each
object's integrating lane adds its rows.  Here the plan is checked on every
shipped arrangement the plant tests use, and the sums it gives, replayed in
numpy, equal the per-object sums taken directly (the plain version's
``index_add``) to rounding.
"""

import numpy as np
import pytest

from upright_tpu_torch.sim.contact import WARP, piece_tables
from upright_tpu_torch.tools.plant_data import plant_for

ARRANGEMENTS = [
    ("thing_demo", None),  # 16 slots, one piece
    ("ur10_demo", "box_arch"),  # three stacked boxes: reactions
    ("ur10_demo", "blue_cups"),  # 112 slots on four warps
    ("ur10_demo", "simulation_box_with_fixture"),  # pieces cut at the warps' edges
    ("ur10_demo", "foam_die2"),  # two stacked dice
]


@pytest.mark.parametrize("demo,arrangement", ARRANGEMENTS,
                         ids=[a or d for d, a in ARRANGEMENTS])
def test_pieces_and_rows_sum_as_the_plain_version(demo, arrangement):
    tables = plant_for(demo, arrangement).tables
    slot_int = tables.slot_int.numpy()
    obj, parent, surface = slot_int[:, 0], slot_int[:, 1], slot_int[:, 2]
    n, n_obj = len(slot_int), tables.n_obj
    piece, rows = tables.slot_piece.numpy(), tables.obj_rows.numpy()
    np.testing.assert_array_equal(
        piece, piece_tables(slot_int, n_obj)[0])  # as built with the tables

    # pieces: runs of one (object, surface) inside one warp, maximal
    ends = piece[:, 0]
    heads = [s for s in range(n) if s == 0 or ends[s - 1] < s]
    for s in range(n):
        e = ends[s]
        assert s <= e < n and s // WARP == e // WARP
        assert (obj[s:e + 1] == obj[s]).all() and (surface[s:e + 1] == surface[s]).all()
    for h in heads:
        e = ends[h]
        assert e + 1 == n or (e + 1) % WARP == 0 or (obj[e + 1], surface[e + 1]) != (
            obj[e], surface[e])
    assert tables.max_piece == max(ends[h] - h + 1 for h in heads) <= WARP
    assert tables.has_reactions == bool((parent >= 0).any())

    # rows: each used once; an object's rows are one contiguous range
    own, react = piece[:, 1], piece[:, 2]
    not_head = np.setdiff1d(np.arange(n), heads)
    assert (own[not_head] == -1).all() and (react[not_head] == -1).all()
    used = sorted([own[h] for h in heads] + [react[h] for h in heads if react[h] >= 0])
    assert used == list(range(tables.n_rows))
    np.testing.assert_array_equal(rows[:, 0], np.cumsum(rows[:, 1]) - rows[:, 1])
    assert rows[:, 1].sum() == tables.n_rows
    for h in heads:
        assert rows[obj[h], 0] <= own[h] < rows[obj[h], 0] + rows[obj[h], 1]
        assert (react[h] >= 0) == (parent[h] >= 0)
        if parent[h] >= 0:
            assert rows[parent[h], 0] <= react[h] < rows[parent[h], 0] + rows[parent[h], 1]

    # the kernel's sums, replayed: force on each slot, the reaction on its parent
    f = np.random.default_rng(0).standard_normal((n, 3))
    row_sum = np.zeros((tables.n_rows, 3))
    for h in heads:
        s = f[h:ends[h] + 1].sum(0)
        row_sum[own[h]] += s
        if react[h] >= 0:
            row_sum[react[h]] -= s
    got = np.stack([row_sum[r0:r0 + rc].sum(0) for r0, rc in rows])
    want = np.zeros((n_obj, 3))
    np.add.at(want, obj, f)
    on_obj = parent >= 0
    np.add.at(want, parent[on_obj], -f[on_obj])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
