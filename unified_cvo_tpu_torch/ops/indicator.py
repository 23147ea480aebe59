"""Sliding-window sparsity indicator driving the lengthscale schedule
(port of unified_cvo_tpu/ops/indicator.py).

Transcription of A_sparsity_indicator_ell_update (reference
src/cvo/CvoGPU.cu:1167-1285): two FIFO windows of the indicator
(nonzeros / sqrt(|X||Y|)); when the two window sums agree within
indicator_stable_threshold the lengthscale may decay and both windows reset.
The reference's queue quirks are kept: on the boundary iteration one value
lands in both windows (the start queue fills and the following `if` pushes
the same value into the end queue).

The std::queues are fixed [W] circular buffers on the device. Every branch
is computed and selected with `torch.where`, so an update never reads
anything back to the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class IndicatorState(NamedTuple):
    sbuf: torch.Tensor   # [W] start-window circular buffer
    shead: torch.Tensor  # int32
    scnt: torch.Tensor   # int32
    ssum: torch.Tensor   # f32
    ebuf: torch.Tensor   # [W] end-window circular buffer
    ehead: torch.Tensor
    ecnt: torch.Tensor
    esum: torch.Tensor


def init_state(window: int, device=None, lanes: Optional[int] = None) -> IndicatorState:
    """Empty windows; with `lanes`, one state per lane (buffers [lanes, W],
    the rest [lanes])."""
    lead = () if lanes is None else (lanes,)
    z32 = torch.zeros(lead, dtype=torch.int32, device=device)
    zf = torch.zeros(lead, dtype=torch.float32, device=device)
    buf = torch.zeros(lead + (window,), dtype=torch.float32, device=device)
    return IndicatorState(buf, z32, z32, zf, buf, z32, z32, zf)


def update(state: IndicatorState, indicator: torch.Tensor,
           stable_threshold: float):
    """One indicator observation -> (new_state, decrease_ell: bool tensor).
    A state with a lane axis takes one observation per lane."""
    W = state.sbuf.shape[-1]
    ind = indicator.to(torch.float32)
    lane = torch.arange(W, device=ind.device)
    sbuf, shead, scnt, ssum, ebuf, ehead, ecnt, esum = state

    def col(v):
        return v[..., None]          # a per-state value against the buffers

    # cond 1: start window not yet full -> push (CvoGPU.cu:1177-1181)
    c1 = scnt < W
    sbuf = torch.where(col(c1) & (lane == col(torch.remainder(shead + scnt, W))), col(ind), sbuf)
    ssum = torch.where(c1, ssum + ind, ssum)
    scnt = scnt + c1.to(torch.int32)

    # cond 2: start full, end not full -> push the same value into end
    # (CvoGPU.cu:1182-1186; evaluated with the updated start count)
    c2 = (scnt >= W) & (ecnt < W)
    ebuf = torch.where(col(c2) & (lane == col(torch.remainder(ehead + ecnt, W))), col(ind), ebuf)
    esum = torch.where(c2, esum + ind, esum)
    ecnt = ecnt + c2.to(torch.int32)

    # cond 3: both full -> ratio test (CvoGPU.cu:1192-1238)
    both_full = (scnt >= W) & (ecnt >= W)
    ratio = esum / torch.where(ssum == 0, torch.full_like(ssum, 1e-30), ssum)
    stable = (ratio > 1.0 - stable_threshold) & (ratio < 1.0 + stable_threshold)
    decrease = both_full & stable
    shift = both_full & ~stable

    # shift: move end.front into start (dropping start.front), append ind
    at_s = lane == col(shead)
    at_e = lane == col(ehead)
    f = torch.sum(torch.where(at_e, ebuf, torch.zeros_like(ebuf)), dim=-1)
    sf = torch.sum(torch.where(at_s, sbuf, torch.zeros_like(sbuf)), dim=-1)
    sbuf = torch.where(col(shift) & at_s, col(f), sbuf)
    ssum = torch.where(shift, ssum + f - sf, ssum)
    shead = torch.where(shift, torch.remainder(shead + 1, W), shead)
    ebuf = torch.where(col(shift) & at_e, col(ind), ebuf)
    esum = torch.where(shift, esum + ind - f, esum)
    ehead = torch.where(shift, torch.remainder(ehead + 1, W), ehead)

    # reset: both windows start over
    keep = ~decrease
    zf = torch.zeros_like(ssum)
    zi = torch.zeros_like(scnt)
    new = IndicatorState(
        sbuf=torch.where(col(keep), sbuf, torch.zeros_like(sbuf)),
        shead=torch.where(keep, shead, zi),
        scnt=torch.where(keep, scnt, zi),
        ssum=torch.where(keep, ssum, zf),
        ebuf=torch.where(col(keep), ebuf, torch.zeros_like(ebuf)),
        ehead=torch.where(keep, ehead, zi),
        ecnt=torch.where(keep, ecnt, zi),
        esum=torch.where(keep, esum, zf),
    )
    return new, decrease
