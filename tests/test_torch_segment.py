"""The fixed-order segment sum (ops/segment.py) that replaced index_add in
the pose graph's and the IRLS solver's assemblies, on the CPU.

- incidence(): each key's positions in increasing order, padded with the
  index of the zero row; empty and single-key inputs, a row count that
  does not fit the table;
- segment_sum against index_add and against a float64 sum, rtol / atol
  1e-5 (float32 sums of up to ~60 unit-scale terms, reassociated), for [M],
  [M, 6] and [M, 6, 6] rows, keys that repeat up to ~60 times, keys that
  never occur;
- a key's sum depends only on its own rows in their own order: the keys
  interleaved another way give the same bits;
- the assemblies that use it: the IRLS gradient and block diagonal, the pose
  graph's dense block system, against index_add.
"""

import numpy as np
import pytest
import torch

from unified_cvo_tpu_torch.models import irls
from unified_cvo_tpu_torch.ops import segment

torch.set_num_threads(1)


def test_incidence_lists_positions_in_order():
    keys = torch.tensor([3, 1, 3, 0, 3, 1])
    inc = segment.incidence(keys, 5)
    assert inc.m == 6
    assert inc.table.tolist() == [[3, 6, 6], [1, 5, 6], [6, 6, 6], [0, 2, 4], [6, 6, 6]]


def test_incidence_edge_cases():
    inc = segment.incidence(torch.zeros(0, dtype=torch.int64), 4)
    assert inc.table.shape == (4, 0)
    out = segment.segment_sum(inc, torch.zeros((0, 6)))
    assert torch.equal(out, torch.zeros((4, 6)))
    inc = segment.incidence(torch.full((7,), 2), 3)
    assert inc.table.tolist() == [[7] * 7, [7] * 7, list(range(7))]
    with pytest.raises(ValueError):
        segment.segment_sum(inc, torch.zeros((6, 2)))


def test_segment_sum_of_parts_is_the_sum_of_their_concatenation():
    rng = np.random.default_rng(5)
    keys = torch.from_numpy(rng.integers(0, 6, 50))
    a, b = (torch.from_numpy(rng.normal(size=(25, 6, 6)).astype(np.float32)) for _ in range(2))
    inc = segment.incidence(keys, 6)
    assert torch.equal(segment.segment_sum(inc, a, b),
                       segment.segment_sum(inc, torch.cat([a, b])))


@pytest.mark.parametrize("shape", [(), (6,), (6, 6)], ids=["scalar", "vector", "block"])
@pytest.mark.parametrize("n,m", [(10, 40), (50, 400), (3, 120)])
def test_segment_sum_matches_index_add_and_float64(shape, n, m):
    rng = np.random.default_rng(n * m + len(shape))
    keys = rng.integers(0, n, m)
    keys[keys == n - 1] = 0                     # a key that never occurs
    rows = rng.normal(size=(m,) + shape).astype(np.float32)
    kt, rt = torch.from_numpy(keys), torch.from_numpy(rows)
    got = segment.segment_sum(segment.incidence(kt, n), rt)
    want = torch.zeros((n,) + shape).index_add(0, kt, rt)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    exact = np.zeros((n,) + shape)
    np.add.at(exact, keys, rows.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), exact, rtol=1e-5, atol=1e-5)
    assert torch.all(got[n - 1] == 0)


def test_segment_sum_depends_only_on_each_keys_own_order():
    """Interleaving the keys another way, each key's rows kept in their own
    order, gives the same bits: a key's sum never sees another key's rows
    or the order in which the rows arrive."""
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 4, 200)
    rows = (rng.normal(size=(200, 6)) * 10.0 ** rng.integers(-4, 5, (200, 1))).astype(np.float32)
    perm = np.argsort(rng.random(200))
    perm = np.concatenate([np.sort(perm[keys[perm] == k]) for k in (2, 0, 3, 1)])
    a = segment.segment_sum(segment.incidence(torch.from_numpy(keys), 4), torch.from_numpy(rows))
    b = segment.segment_sum(segment.incidence(torch.from_numpy(keys[perm]), 4),
                            torch.from_numpy(rows[perm]))
    assert torch.equal(a, b)


def _edges(F, E, seed):
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, F, E)
    ej = (ei + rng.integers(1, F, E)) % F
    return torch.from_numpy(ei), torch.from_numpy(ej), rng


def test_irls_assembly_sums_match_index_add():
    F, E = 12, 30
    ei, ej, rng = _edges(F, E, 3)
    H_aa, H_bb = (torch.from_numpy(rng.normal(size=(E, 6, 6)).astype(np.float32))
                  for _ in range(2))
    b_a, b_b = (torch.from_numpy(rng.normal(size=(E, 6)).astype(np.float32)) for _ in range(2))
    inc = irls.edge_incidence(F, ei, ej)
    want_b = torch.zeros((F, 6)).index_add(0, ei, b_a).index_add(0, ej, b_b)
    want_D = torch.zeros((F, 6, 6)).index_add(0, ei, H_aa).index_add(0, ej, H_bb)
    torch.testing.assert_close(irls._gradient(inc, b_a, b_b), want_b, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(irls._gradient(inc, H_aa, H_bb), want_D, rtol=1e-6, atol=1e-6)


def test_posegraph_dense_blocks_match_index_add():
    F, E = 9, 25
    fi, fj, rng = _edges(F, E, 4)
    blocks = [torch.from_numpy(rng.normal(size=(E, 6, 6)).astype(np.float32))
              for _ in range(3)]
    H_aa, H_bb, H_ab = blocks
    keys = torch.cat([fi * F + fi, fj * F + fj, fi * F + fj, fj * F + fi])
    got = segment.segment_sum(segment.incidence(keys, F * F),
                              torch.cat([H_aa, H_bb, H_ab, H_ab.transpose(1, 2)]))
    want = (torch.zeros((F * F, 6, 6)).index_add(0, fi * F + fi, H_aa)
            .index_add(0, fj * F + fj, H_bb).index_add(0, fi * F + fj, H_ab)
            .index_add(0, fj * F + fi, H_ab.transpose(1, 2)))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
