"""LORE wiz_rev corner refinement as dense tensor ops (counterpart of
pdf_table_tpu/models/lore/corner_refine.py::refine_vertices_by_corners and
tasks/table_structure.py::wiz_refine_sort_dev).

Each detected cell's vertices snap to overlapping corner detections: a
(cell, corner) pair is valid when the cell score >= vis_thresh, the corner
score >= vis_thresh_corner, their axis-aligned boxes intersect and some
group-box vertex lies strictly inside the cell quad. Per pair the nearest
cell vertex takes the corner; among a vertex's candidates the one nearest
the original vertex wins, later corners winning ties. A corner is a
refinement event when its distance is <= the running minimum over earlier
valid corners of the same vertex; cells with <= 2 events have their score
multiplied by 0.4. Everything is a (B, K, M) masked tensor op, so the
refine stays on the device between the detect-decode and the regressor.

Comparisons are exact, so the arithmetic keeps the JAX order (no fused
expressions): the point-in-quad cross products, squared distances as
``d * d`` sums, first-minimum ``argmin``, ``cummin`` for the running
minimum and a stable sort of the refined scores.
"""

from __future__ import annotations

from typing import Tuple

import torch

_INF = 1e30


def _point_in_quad(quads: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """quads (..., 4, 2), pts (..., 2) -> bool (...,): strictly inside a
    convex quad (either winding)."""
    v0 = quads
    v1 = torch.roll(quads, -1, dims=-2)
    e = v1 - v0                                   # (..., 4, 2)
    r = pts[..., None, :] - v0                    # (..., 4, 2)
    cross = e[..., 0] * r[..., 1] - e[..., 1] * r[..., 0]
    return (cross > 0).all(dim=-1) | (cross < 0).all(dim=-1)


def refine_vertices_by_corners(
        dets: torch.Tensor, scores: torch.Tensor, gboxes: torch.Tensor,
        gcenters: torch.Tensor, gscores: torch.Tensor, vis_thresh: float,
        vis_thresh_corner: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """dets (B, K, 8) cell quads, scores (B, K); gboxes (B, M, 8) per-corner
    group quads, gcenters (B, M, 2), gscores (B, M) sorted descending.
    Returns (refined dets (B, K, 8), adjusted scores (B, K))."""
    B, K, _ = dets.shape
    M = gboxes.shape[1]
    dev = dets.device
    bb = dets.reshape(B, K, 4, 2)
    gb = gboxes.reshape(B, M, 4, 2)

    # symmetric AABB intersection
    bmin, bmax = bb.amin(2), bb.amax(2)           # (B, K, 2)
    gmin, gmax = gb.amin(2), gb.amax(2)           # (B, M, 2)
    aabb = ((bmin[:, :, None] <= gmax[:, None])
            & (gmin[:, None] <= bmax[:, :, None])).all(dim=-1)  # (B, K, M)

    # any group-box vertex strictly inside the cell quad
    pin = _point_in_quad(bb[:, :, None, None],    # (B, K, 1, 1, 4, 2)
                         gb[:, None]).any(dim=-1)  # (B, 1, M, 4, 2)

    valid = (aabb & pin
             & (scores >= vis_thresh)[:, :, None]
             & (gscores >= vis_thresh_corner)[:, None, :])

    # nearest cell vertex per (cell, corner) and its distance
    d = bb[:, :, None] - gcenters[:, None, :, None]   # (B, K, M, 4, 2)
    d4 = (d * d).sum(dim=-1)                          # (B, K, M, 4)
    v_idx = torch.argmin(d4, dim=-1)                  # first minimum
    d_star = d4.amin(dim=-1)                          # (B, K, M)

    # (B, K, 4, M): distance per vertex slot, INF where not assigned
    slots = torch.arange(4, device=dev)[None, None, :, None]
    per_v = valid[:, :, None, :] & (v_idx[:, :, None, :] == slots)
    inf = torch.tensor(_INF, dtype=d_star.dtype, device=dev)
    dv = torch.where(per_v, d_star[:, :, None, :], inf)

    # sequential-events counter: corner j counts iff d <= running min of
    # the earlier corners (the first valid corner always counts)
    run = torch.cummin(dv, dim=-1).values
    prev = torch.cat([torch.full_like(run[..., :1], _INF), run[..., :-1]],
                     dim=-1)
    events = (dv < inf) & (dv <= prev)
    counts = events.sum(dim=(-1, -2))                 # (B, K)

    # final vertex position: nearest corner, later index winning ties
    dmin = dv.amin(dim=-1)                            # (B, K, 4)
    at_min = (dv == dmin[..., None]) & (dv < inf)
    js = torch.arange(M, device=dev)[None, None, None]
    last_j = torch.where(at_min, js, torch.full_like(js, -1)).amax(dim=-1)
    any_hit = last_j >= 0
    new_pos = torch.gather(
        gcenters, 1,
        last_j.clamp_min(0).reshape(B, K * 4, 1).expand(B, K * 4, 2)
    ).reshape(B, K, 4, 2)
    refined = torch.where(any_hit[..., None], new_pos, bb).reshape(B, K, 8)

    new_scores = torch.where((scores >= vis_thresh) & (counts <= 2),
                             scores * 0.4, scores)
    return refined, new_scores


def refine_sort(dc_packed: torch.Tensor, max_objs: int, vis_thresh: float,
                vis_thresh_corner: float):
    """The device middle of the wiz_rev path: unpack ``detect_decode``'s
    ``dc_packed`` (B, K + M, 11) — cells [dets 8, score, ind, 0], corners
    [gbox 8, center 2, score] — refine, and re-sort the cells by score
    (stable, highest first). Returns (dets (B, K, 8), inds (B, K) int64,
    scores (B, K))."""
    cells, corners = dc_packed[:, :max_objs], dc_packed[:, max_objs:]
    dets, scores = cells[..., :8], cells[..., 8]
    inds = cells[..., 9].long()
    dets, scores = refine_vertices_by_corners(
        dets, scores, corners[..., :8], corners[..., 8:10],
        corners[..., 10], vis_thresh, vis_thresh_corner)
    order = torch.argsort(-scores, dim=1, stable=True)   # jnp.argsort
    return (torch.gather(dets, 1, order[..., None].expand_as(dets)),
            torch.gather(inds, 1, order), torch.gather(scores, 1, order))
