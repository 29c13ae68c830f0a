"""The numbers that decide `correct`, each held to the limit the cell's
workload file gives it.

Per row (one env), against the reference's row:
  state error -- max over the final q and v of |got - want| / (1 + |want|);
  grad error  -- |g_got - g_want| / max(|g_want|, median over rows of
                 |g_want|), norms over the row's whole (T, nv) gradient:
                 measured against the row's own norm or the median row's,
                 whichever is larger, since some rows' gradients are all but
                 zero.
Over the rows compared: the median and the 90th percentile of each, and
`nonfinite`, the rows whose output holds a NaN or an infinity.
"""
from __future__ import annotations

import torch


def _quantiles(err: torch.Tensor, prefix: str) -> dict:
    e = err.double().cpu()
    return {f"{prefix}_median": float(e.quantile(0.5)), f"{prefix}_p90": float(e.quantile(0.9))}


def _nonfinite(*xs) -> torch.Tensor:
    bad = torch.zeros(xs[0].shape[0], dtype=torch.bool, device=xs[0].device)
    for x in xs:
        bad |= ~torch.isfinite(x.reshape(x.shape[0], -1)).all(dim=1)
    return bad


def state_numbers(q, v, q_ref, v_ref) -> dict:
    """Rows first: q (n, nq), v (n, nv)."""
    err = torch.cat([((q - q_ref).abs() / (1 + q_ref.abs())),
                     ((v - v_ref).abs() / (1 + v_ref.abs()))], dim=1).amax(dim=1)
    bad = _nonfinite(q, v)
    err = torch.where(bad, torch.full_like(err, float("inf")), err)
    return {**_quantiles(err, "state_err"), "nonfinite": int(bad.sum())}


def grad_numbers(g, g_ref) -> dict:
    """g (T, n, nv): the gradient with respect to each row's control tape."""
    g, g_ref = g.transpose(0, 1).flatten(1).double(), g_ref.transpose(0, 1).flatten(1).double()
    norm = g_ref.norm(dim=1)
    err = (g - g_ref).norm(dim=1) / torch.clamp(norm, min=float(norm.median()))
    bad = _nonfinite(g)
    err = torch.where(bad, torch.full_like(err, float("inf")), err)
    return {**_quantiles(err, "grad_err"), "nonfinite_grad": int(bad.sum())}


def worst(readings: list) -> dict:
    """The largest reading of each number over several compared iterations."""
    return {k: max(r[k] for r in readings) for k in readings[0]}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every limit has its number,
    at or under it; a number with no limit is shown with limit null and
    decides nothing. A cell whose file gives no limit is not correct."""
    shown = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    ok = bool(limits) and all(k in numbers and numbers[k] <= limits[k] for k in limits)
    return ok, shown
