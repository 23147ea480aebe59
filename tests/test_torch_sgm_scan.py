"""The SGM recurrence (unified_cvo_tpu_torch/ops/sgm.py::_sgm_scan) on the
CPU, where it runs its plain version (`sgm_scan_plain`; on a CUDA tensor it
launches csrc/sgm.cu, held against the plain version by chip_smoke.py
phase 15s).

Each case is held int32-equal against the JAX package's `_sgm_scan`
(unified_cvo_tpu/ops/sgm.py, a `lax.scan`) and against a numpy
transcription of the recurrence in int64, on costs made from a seed. JAX's
scan has no cap, so the saturating case is held against the numpy
transcription alone."""

import numpy as np
import pytest
import torch

from unified_cvo_tpu.ops import sgm as j_sgm
from unified_cvo_tpu_torch.ops import sgm as t_sgm

torch.set_num_threads(1)

INF = 1 << 28

# name: (S, G, L, D, n_shift, mask, P1, P2, largest cost). mask: None (every
# line has a predecessor), "xcols" (the vertical scan's: the shifted members'
# line 0 has none) or "random".
CASES = {
    "horizontal_d16": (23, 2, 5, 16, 0, None, 10, 120, 24),
    "horizontal_d48": (19, 2, 4, 48, 0, None, 10, 120, 24),
    "horizontal_d128": (9, 2, 3, 128, 0, None, 10, 120, 24),
    "vertical_d16": (7, 4, 13, 16, 2, "xcols", 10, 120, 24),
    "vertical_d48": (11, 4, 6, 48, 2, "xcols", 10, 120, 24),
    "vertical_d128": (5, 4, 9, 128, 2, "xcols", 10, 120, 24),
    "shifted_no_mask": (6, 1, 9, 16, 1, None, 10, 120, 24),
    "shifted_no_mask_s_over_l": (12, 3, 5, 48, 2, None, 10, 120, 24),
    "sgbm_block_costs": (8, 4, 7, 48, 0, None, 200, 800, 4000),
    "random_mask": (10, 3, 7, 48, 1, "random", 10, 120, 24),
    "s1": (1, 4, 6, 16, 2, "xcols", 10, 120, 24),
    "l1": (8, 4, 1, 16, 2, "xcols", 10, 120, 24),
}


def _inputs(S, G, L, D, n_shift, mask, high, seed):
    rng = np.random.default_rng(seed)
    costs = rng.integers(0, high + 1, (S, G, L, D)).astype(np.int32)
    if mask is None:
        hp = None
    elif mask == "xcols":
        hp = np.ones((G, L), bool)
        hp[G - n_shift:, 0] = False
    else:
        hp = rng.random((G, L)) < 0.7
    return costs, hp


def numpy_scan(costs, hp, n_shift, P1, P2, cap=None):
    """The recurrence in int64 numpy: the last n_shift members' state moves
    one line a step (line 0 takes INF and minprev 0), Lc saturates at cap,
    lines without a predecessor restart at the cost from step 1."""
    c = costs.astype(np.int64)
    S, G, L, D = c.shape
    out = np.empty_like(c)
    out[0] = c[0]
    k = G - n_shift
    for s in range(1, S):
        Lp, mp = out[s - 1].copy(), out[s - 1].min(-1)
        Lp[k:, 1:], Lp[k:, 0] = out[s - 1][k:, :-1], INF
        mp[k:, 1:], mp[k:, 0] = out[s - 1][k:, :-1].min(-1), 0
        pd = np.pad(Lp, ((0, 0), (0, 0), (1, 1)), constant_values=INF)
        best = np.minimum(Lp, np.minimum(np.minimum(pd[..., :-2], pd[..., 2:]) + P1,
                                         mp[..., None] + P2))
        Lc = c[s] + best - mp[..., None]
        if cap is not None:
            Lc = np.minimum(Lc, cap)
        out[s] = Lc if hp is None else np.where(hp[..., None], Lc, c[s])
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_sgm_scan_matches_jax(name):
    S, G, L, D, n_shift, mask, P1, P2, high = CASES[name]
    costs, hp = _inputs(S, G, L, D, n_shift, mask, high, seed=len(name))
    t_sgm.reset_launches()
    got = t_sgm._sgm_scan(torch.from_numpy(costs), None if hp is None else torch.from_numpy(hp),
                          n_shift, P1, P2)
    assert got.dtype == torch.int32 and tuple(got.shape) == (S, G, L, D)
    assert t_sgm._sgm_scan.launches == 0
    shift = np.arange(G) >= G - n_shift
    want = np.asarray(j_sgm._sgm_scan(costs, np.ones((G, L), bool) if hp is None else hp,
                                      shift, P1, P2))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), numpy_scan(costs, hp, n_shift, P1, P2))


@pytest.mark.parametrize("n_shift,mask", [(0, None), (2, "xcols")])
def test_sgm_scan_cap(n_shift, mask):
    """native/cvo_native.cpp's uint16 saturation at 60000 with P2 65000:
    costs up to 30000 spread the path costs past the cap within a few
    steps, so it binds, and the saturated values feed the next step."""
    costs, hp = _inputs(9, 4, 6, 16, n_shift, mask, 30000, seed=5)
    hp_t = None if hp is None else torch.from_numpy(hp)
    got = t_sgm._sgm_scan(torch.from_numpy(costs), hp_t, n_shift, 10, 65000, cap=60000).numpy()
    want = numpy_scan(costs, hp, n_shift, 10, 65000, cap=60000)
    np.testing.assert_array_equal(got, want)
    assert (want == 60000).any() and (numpy_scan(costs, hp, n_shift, 10, 65000) > 60000).any()


def test_sgm_scan_dispatch():
    """A CPU tensor runs the plain version and launches nothing; a tensor on
    a device that is neither CPU nor CUDA is refused."""
    costs, hp = _inputs(5, 4, 6, 16, 2, "xcols", 24, seed=1)
    c, h = torch.from_numpy(costs), torch.from_numpy(hp)
    t_sgm.reset_launches()
    assert torch.equal(t_sgm._sgm_scan(c, h, 2, 10, 120), t_sgm.sgm_scan_plain(c, h, 2, 10, 120))
    assert t_sgm._sgm_scan.launches == 0
    with pytest.raises(ValueError, match="unsupported device"):
        t_sgm._sgm_scan(c.to("meta"), h.to("meta"), 2, 10, 120)
    assert t_sgm._sgm_scan.launches == 0
