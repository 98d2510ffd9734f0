"""Byzantine-robust lane reducers (the port's twin of the JAX package's
``core/robust.py``), the alternatives to the eq.-11 weighted mean that
``AggSpec.reducer`` selects:

* ``median``        — per-coordinate median over the group's valid lanes;
* ``trimmed_mean``  — per-coordinate mean after dropping the
  ``floor(trim_frac * m)`` smallest and largest valid values;
* ``krum``          — Krum (Blanchard et al., NeurIPS 2017): select the
  lane whose summed squared distance to its ``m - f - 2`` nearest valid
  neighbours is smallest.

The engines call ``robust_agg`` on the trained ``(C, P)`` lane stack after
the adversary's delta transform, in place of ``aggv @ lanes``. The port's
lanes already are one flat buffer in the sorted-leaf layout, which is the
order the reference's ``flatten_lanes`` ravels a lane-stacked tree in, so
that helper has no counterpart here.

Masking is the load-bearing part: ghost lanes, ring-tail lanes, lanes of
dropped clients and whole dropped edges all arrive as weight-0 entries of
the uncollapsed (G, C) lane-weight matrix. A linear reduce ignores them
for free; a sort does not, since a zero weight still contributes a zero
value to an order statistic. So validity is ``weight > 0``: invalid lanes
go to +inf before the sort and the sorted values are zeroed wherever the
position weight is 0 (no ``0 * inf`` NaN), or they are left out of Krum's
distances and scores. The statistics are unweighted over the valid lanes;
the group level stays the linear ``gw`` mean.

Everything runs on the lanes' device from tensors (valid counts included),
with position weights built from ``arange`` comparisons as the reference
builds them, so a fused block with a robust reduce stays one call that
never reads the device back. The rules are the reference's to the letter:
the median averages sorted positions ``(m - 1) // 2`` and ``m // 2``; the
trimmed mean keeps ``k = min(floor(trim_frac * m), (m - 1) // 2)`` per
side, ``trim_frac * m`` in float32; Krum's distances are
``|x_i|^2 + |x_j|^2 - 2 x_i . x_j`` from one Gram matrix, invalid pairs
and the diagonal at ``_BIG``, and the selection is ``argmin``, the first
minimum on a tie, as ``jnp.argmin`` takes it. A group without a valid lane
gives a zero row.
"""
from __future__ import annotations

import torch

REDUCERS = ("median", "trimmed_mean", "krum")

# large but finite stand-in for +inf in Krum's distance matrix; the scores
# of invalid lanes are set to the real inf before the argmin
_BIG = 1e30


def _order_weights(reducer: str, trim_frac: float, m: torch.Tensor,
                   idx: torch.Tensor) -> torch.Tensor:
    """(G, C) position weights over the ascending sort of each group's m
    valid entries (the invalid ones sort to positions >= m, at +inf)."""
    f32 = torch.float32
    m = m.view(-1, 1)
    i = idx.view(1, -1)
    if reducer == "median":
        lo = torch.div(m - 1, 2, rounding_mode="floor")
        hi = torch.div(m, 2, rounding_mode="floor")
        pw = 0.5 * ((i == lo).to(f32) + (i == hi).to(f32))
    else:   # trimmed_mean
        frac = torch.tensor(trim_frac, dtype=f32, device=m.device)
        k = torch.minimum(torch.floor(frac * m.to(f32)).to(m.dtype),
                          torch.div(m - 1, 2, rounding_mode="floor"))
        pw = (((i >= k) & (i < m - k)).to(f32)
              / torch.clamp(m - 2 * k, min=1).to(f32))
    # a group whose lanes all dropped gives a zero row (its group weight is
    # zero too), not a 0.5 * inf NaN
    return torch.where(m > 0, pw, torch.zeros((), dtype=f32, device=m.device))


def krum_scores(flat: torch.Tensor, mask: torch.Tensor,
                krum_f: int) -> torch.Tensor:
    """(G, C) Krum scores of the (C, P) lanes under the (G, C) validity
    ``mask``: each valid lane's summed squared distance to its
    ``clip(m - f - 2, 1, max(m - 1, 1))`` nearest valid lanes; an invalid
    lane scores inf. A group of one valid lane has no valid pair, so that
    lane scores ``_BIG`` and is still chosen."""
    C = flat.shape[0]
    idx = torch.arange(C, device=flat.device)
    sq = torch.sum(flat * flat, dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (flat @ flat.T)           # (C, C)
    pair_ok = (mask[:, :, None] & mask[:, None, :]
               & (idx[:, None] != idx[None, :]))                      # (G, C, C)
    d2 = torch.where(pair_ok, d2, _BIG)
    m = mask.sum(dim=1)
    nn = torch.minimum(torch.clamp(m - krum_f - 2, min=1),
                       torch.clamp(m - 1, min=1))
    ds = torch.sort(d2, dim=2).values
    score = torch.sum(torch.where(idx.view(1, 1, -1) < nn.view(-1, 1, 1),
                                  ds, 0.0), dim=2)
    return torch.where(mask, score, torch.inf)


def robust_agg(lanes: torch.Tensor, wm, gw, reducer: str,
               trim_frac: float = 0.0, krum_f: int = 0) -> torch.Tensor:
    """Robust reduce of a (C, P) lane stack.

    ``wm`` is the uncollapsed (G, C) lane-weight matrix (a tensor or a
    host array); only its ``> 0`` pattern, each group's valid lanes, is
    read. ``gw`` collapses the (G, P) group results with the (G,) group
    weights into one (P,) model; ``gw=None`` returns the (G, P) group
    stack (HierFAVG's intermediate edge iterations). The result is a new
    tensor, never a view of a lane."""
    if reducer not in REDUCERS:
        raise ValueError(f"unknown robust reducer {reducer!r}")
    dev = lanes.device
    wm = torch.as_tensor(wm, dtype=torch.float32, device=dev)
    mask = wm > 0                                                     # (G, C)
    m = mask.sum(dim=1)
    idx = torch.arange(lanes.shape[0], device=dev)
    if reducer == "krum":
        sel = torch.argmin(krum_scores(lanes, mask, krum_f), dim=1)
        pw = (idx.view(1, -1) == sel.view(-1, 1)).to(lanes.dtype)
        pw = torch.where(m.view(-1, 1) > 0, pw, 0.0)
        rows = pw @ lanes                                             # (G, P)
    else:
        svals = torch.sort(torch.where(mask.unsqueeze(2), lanes.unsqueeze(0),
                                       torch.inf), dim=1).values       # (G, C, P)
        pw = _order_weights(reducer, trim_frac, m, idx)
        svals = torch.where((pw > 0).unsqueeze(2), svals, 0.0)
        rows = torch.bmm(pw.to(lanes.dtype).unsqueeze(1), svals).squeeze(1)
    if gw is None:
        return rows
    return torch.as_tensor(gw, dtype=rows.dtype, device=dev) @ rows
