"""Rotated-box IoU, rotated NMS and the rotated postprocess, batched.

A port of `mydetection_tpu/ops/rotated.py`. Boxes are (cx, cy, w, h, θ)
with θ in radians, counter-clockwise.

- The production IoU (`pairwise_rotated_iou`) is the analytic
  Liang–Barsky form: each box's edges are clipped to the other box in
  its frame, and the clipped segments' shoelace terms sum to the area of
  the intersection; no polygon, no sort. The JAX order of operations is
  kept, since a keep-mask flips on an ulp near the threshold: both boxes
  recentred at their midpoint, slab clips with no epsilon on the bounds,
  the `|d| < 1e-4` parallel branch, the ½ weight on shared faces, the
  min-area clamp, `inter / max(union, 1e-9)`. cos/sin are taken once per
  box and broadcast to the pairs.
- The 24-candidate polygon construction (`rotated_intersection_area`)
  is kept as the oracle the tests hold the production form against.
- `rotated_postprocess` is the JAX `rotated_postprocess_impl` with the
  image axis written out where the JAX package vmaps: conf gate →
  stable top-`pre_nms` → the (B, K, K) IoU matrix as tensor ops → the
  greedy suppress kernel (`kernels/rotated_nms.py`, one launch for the
  batch) → stable top-`max_dets`.
"""

from __future__ import annotations

import torch

from mydetection_tpu_torch.kernels.rotated_nms import (
    nms_from_iou_keep,
    nms_from_iou_keep_plain,
)
from mydetection_tpu_torch.kernels.route import pick
from mydetection_tpu_torch.ops.nms import NEG_INF, _rows, _top_k_padded, top_k

EPS = 1e-9
# Pixel-scale boundary tolerances (float32 coordinates up to ~1e4 px):
# a box's corners must pass its own inside test after the rotate round
# trip.
EPS_INSIDE = 1e-3
EPS_SEG = 1e-4


def _corners(cx, cy, w, h, cos, sin):
    """Corner x and y (..., 4), CCW, of boxes given as broadcastable
    components."""
    dx = torch.stack([-w, w, w, -w], dim=-1) * 0.5
    dy = torch.stack([-h, -h, h, h], dim=-1) * 0.5
    cos, sin = cos[..., None], sin[..., None]
    x = cx[..., None] + dx * cos - dy * sin
    y = cy[..., None] + dx * sin + dy * cos
    return x, y


def box_corners(boxes: torch.Tensor, trig=None) -> torch.Tensor:
    """Corners of rotated boxes (..., 5) → (..., 4, 2), CCW. `trig`:
    optional precomputed (cos θ, sin θ)."""
    cx, cy, w, h, th = boxes.unbind(-1)
    cos, sin = trig if trig is not None else (torch.cos(th), torch.sin(th))
    return torch.stack(_corners(cx, cy, w, h, cos, sin), dim=-1)


# ---------------------------------------------------------------------------
# the 24-candidate polygon oracle (tests only)
# ---------------------------------------------------------------------------

def _points_in_box(pts: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """pts (..., P, 2) inside rotated box (..., 5) → bool (..., P)."""
    cx, cy, w, h, th = box.unbind(-1)
    rel = pts - torch.stack([cx, cy], dim=-1)[..., None, :]
    cos, sin = torch.cos(th)[..., None], torch.sin(th)[..., None]
    lx = rel[..., 0] * cos + rel[..., 1] * sin
    ly = -rel[..., 0] * sin + rel[..., 1] * cos
    return ((lx.abs() <= w[..., None] * 0.5 + EPS_INSIDE)
            & (ly.abs() <= h[..., None] * 0.5 + EPS_INSIDE))


def _segment_intersections(ca: torch.Tensor, cb: torch.Tensor):
    """All 16 edge-pair intersections of two quads (..., 4, 2): points
    (..., 16, 2) and their validity (..., 16)."""
    a1 = torch.roll(ca, -1, dims=-2)
    b1 = torch.roll(cb, -1, dims=-2)
    p, r = ca[..., :, None, :], (a1 - ca)[..., :, None, :]
    q, s = cb[..., None, :, :], (b1 - cb)[..., None, :, :]
    rxs = r[..., 0] * s[..., 1] - r[..., 1] * s[..., 0]
    qp = q - p
    den = torch.where(rxs.abs() < EPS, 1.0, rxs)
    t = (qp[..., 0] * s[..., 1] - qp[..., 1] * s[..., 0]) / den
    u = (qp[..., 0] * r[..., 1] - qp[..., 1] * r[..., 0]) / den
    valid = ((rxs.abs() >= EPS) & (t >= -EPS_SEG) & (t <= 1 + EPS_SEG)
             & (u >= -EPS_SEG) & (u <= 1 + EPS_SEG))
    pts = p + t[..., None] * r
    batch = ca.shape[:-2]
    return pts.reshape(*batch, 16, 2), valid.reshape(*batch, 16)


def rotated_intersection_area(box_a: torch.Tensor,
                              box_b: torch.Tensor) -> torch.Tensor:
    """Intersection area of rotated boxes (..., 5) × (..., 5) → (...):
    the polygon of the valid candidates among 16 edge crossings and 8
    corners, sorted by angle around its centroid (a stable sort), then
    the shoelace."""
    ca, cb = box_corners(box_a), box_corners(box_b)
    inter_pts, inter_valid = _segment_intersections(ca, cb)
    pts = torch.cat([inter_pts, ca, cb], dim=-2)                  # (..., 24, 2)
    valid = torch.cat([inter_valid, _points_in_box(ca, box_b),
                       _points_in_box(cb, box_a)], dim=-1)        # (..., 24)
    cnt = valid.sum(dim=-1)
    centroid = (torch.where(valid[..., None], pts, 0.0).sum(dim=-2)
                / cnt.clamp_min(1)[..., None])
    rel = pts - centroid[..., None, :]
    ang = torch.where(valid, torch.atan2(rel[..., 1], rel[..., 0]),
                      torch.inf)                                  # invalid last
    order = torch.argsort(ang, dim=-1, stable=True)
    sorted_pts = torch.take_along_dim(pts, order[..., None], dim=-2)
    idx = torch.arange(24, device=pts.device)
    nxt = torch.where(idx + 1 < cnt[..., None], idx + 1, 0)      # wrap
    nxt_pts = torch.take_along_dim(sorted_pts, nxt[..., None], dim=-2)
    cross = (sorted_pts[..., 0] * nxt_pts[..., 1]
             - sorted_pts[..., 1] * nxt_pts[..., 0])
    area = 0.5 * torch.where(idx < cnt[..., None], cross, 0.0).sum(-1).abs()
    return torch.where(cnt >= 3, area, 0.0)


# ---------------------------------------------------------------------------
# the production Liang–Barsky IoU
# ---------------------------------------------------------------------------

def _axis_interval(q0, d, half):
    """[t_in, t_out] for |q0 + t d| <= half (slab clip). An edge
    parallel to the slab (|d| < 1e-4 px: the rotate round trip leaves
    ~1e-6 on exactly parallel edges) is taken whole when inside, with a
    boundary tolerance, else not at all."""
    par = d.abs() < 1e-4
    inside = q0.abs() <= half + EPS_INSIDE
    d_safe = torch.where(par, 1.0, d)
    ta = (-half - q0) / d_safe
    tb = (half - q0) / d_safe
    lo = torch.where(par, torch.where(inside, 0.0, 1.0), torch.minimum(ta, tb))
    hi = torch.where(par, torch.where(inside, 1.0, 0.0), torch.maximum(ta, tb))
    return lo, hi


def _clipped_edge_contrib(px, py, cx, cy, w, h, cos, sin):
    """Shoelace line integral of the edges of the quad with corners
    (px, py) (..., 4), CCW, clipped to the box (cx, cy, w, h) with
    rotation (cos, sin), all broadcastable (...). Returns (...)."""
    cx, cy, w, h, cos, sin = (t[..., None] for t in (cx, cy, w, h, cos, sin))
    rx = px - cx
    ry = py - cy
    x0 = rx * cos + ry * sin          # corners in the box frame; the
    y0 = -rx * sin + ry * cos         # edge ends are the next corners
    x1 = torch.roll(x0, -1, dims=-1)
    y1 = torch.roll(y0, -1, dims=-1)
    dx, dy = x1 - x0, y1 - y0
    # no epsilon on the slab bounds: the two clip passes sum to the
    # area only when their pieces close exactly
    hw, hh = w * 0.5, h * 0.5
    lo_x, hi_x = _axis_interval(x0, dx, hw)
    lo_y, hi_y = _axis_interval(y0, dy, hh)
    t0 = torch.clamp(torch.maximum(lo_x, lo_y), 0.0, 1.0)
    t1 = torch.clamp(torch.minimum(hi_x, hi_y), 0.0, 1.0)
    nonempty = t1 > t0        # an empty segment's cross leaves residue
    t1 = torch.maximum(t1, t0)
    ax = x0 + t0 * dx
    ay = y0 + t0 * dy
    bx = x0 + t1 * dx
    by = y0 + t1 * dy
    # a segment on the box's own face belongs to both boundaries: ½
    # each, with the tolerance of the slab's inside test
    tol = EPS_INSIDE
    on_face = ((((ax.abs() - hw).abs() <= tol) & ((bx.abs() - hw).abs() <= tol)
                & (torch.sign(ax) == torch.sign(bx)))
               | (((ay.abs() - hh).abs() <= tol)
                  & ((by.abs() - hh).abs() <= tol)
                  & (torch.sign(ay) == torch.sign(by))))
    weight = torch.where(nonempty, torch.where(on_face, 0.5, 1.0), 0.0)
    # back to the common frame before the cross
    gax = cx + ax * cos - ay * sin
    gay = cy + ax * sin + ay * cos
    gbx = cx + bx * cos - by * sin
    gby = cy + bx * sin + by * cos
    cr = weight * (gax * gby - gbx * gay)
    return 0.5 * (((cr[..., 0] + cr[..., 1]) + cr[..., 2]) + cr[..., 3])


def _inter_area_lb(a, b, trig_a, trig_b):
    """Liang–Barsky intersection area of boxes given as broadcastable
    components a = (cx, cy, w, h), b likewise, with (cos, sin) each."""
    acx, acy, aw, ah = a
    bcx, bcy, bw, bh = b
    # recentre at the midpoint: the crosses cancel catastrophically in
    # float32 at image-scale offsets
    mx = 0.5 * (acx + bcx)
    my = 0.5 * (acy + bcy)
    acx, acy, bcx, bcy = acx - mx, acy - my, bcx - mx, bcy - my
    ax, ay = _corners(acx, acy, aw, ah, *trig_a)
    bx, by = _corners(bcx, bcy, bw, bh, *trig_b)
    area = (_clipped_edge_contrib(ax, ay, bcx, bcy, bw, bh, *trig_b)
            + _clipped_edge_contrib(bx, by, acx, acy, aw, ah, *trig_a)).abs()
    # identical boxes integrate their shared boundary twice: clamp
    return torch.minimum(area, torch.minimum(aw * ah, bw * bh))


def _iou_from_parts(a, b, trig_a, trig_b):
    inter = _inter_area_lb(a, b, trig_a, trig_b)
    union = a[2] * a[3] + b[2] * b[3] - inter
    return inter / torch.clamp_min(union, EPS)


def rotated_intersection_area_lb(box_a: torch.Tensor,
                                 box_b: torch.Tensor) -> torch.Tensor:
    """Elementwise Liang–Barsky intersection area, (..., 5) → (...)."""
    a, b = box_a.unbind(-1), box_b.unbind(-1)
    return _inter_area_lb(a[:4], b[:4], (torch.cos(a[4]), torch.sin(a[4])),
                          (torch.cos(b[4]), torch.sin(b[4])))


def rotated_iou(box_a: torch.Tensor, box_b: torch.Tensor) -> torch.Tensor:
    """Elementwise rotated IoU, (..., 5) × (..., 5) → (...)."""
    a, b = box_a.unbind(-1), box_b.unbind(-1)
    return _iou_from_parts(a[:4], b[:4], (torch.cos(a[4]), torch.sin(a[4])),
                           (torch.cos(b[4]), torch.sin(b[4])))


def pairwise_rotated_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rotated IoU matrix (..., N, 5) × (..., M, 5) → (..., N, M), e.g.
    (B, K, 5) × (B, K, 5) → (B, K, K). Views broadcast per-box values to
    the pairs; cos/sin are taken once per box."""
    ca, cb = a.unbind(-1), b.unbind(-1)
    trig_a = (torch.cos(ca[4])[..., :, None], torch.sin(ca[4])[..., :, None])
    trig_b = (torch.cos(cb[4])[..., None, :], torch.sin(cb[4])[..., None, :])
    return _iou_from_parts([t[..., :, None] for t in ca[:4]],
                           [t[..., None, :] for t in cb[:4]], trig_a, trig_b)


# ---------------------------------------------------------------------------
# rotated NMS and postprocess
# ---------------------------------------------------------------------------

def rotated_nms_padded(boxes: torch.Tensor, scores: torch.Tensor, *,
                       iou_thres: float = 0.45, block: int = 64
                       ) -> torch.Tensor:
    """Greedy NMS with rotated IoU over B images: boxes (B, K, 5) and
    scores (B, K), rows sorted by descending score, padding rows at
    NEG_INF. Returns the bool keep-mask (B, K)."""
    valid = scores > NEG_INF / 2
    iou = pairwise_rotated_iou(boxes, boxes)
    return pick(nms_from_iou_keep, nms_from_iou_keep_plain)(
        iou.contiguous(), valid.contiguous(), iou_thres, block=block)


def rotated_postprocess(boxes: torch.Tensor, scores: torch.Tensor, *,
                        conf_thres, iou_thres: float, pre_nms: int = 512,
                        max_dets: int = 100, block: int = 64
                        ) -> dict[str, torch.Tensor]:
    """Dense rotated predictions → padded detections per image.

    boxes (B, N, 5) cxcywhθ float32, scores (B, N) single-class;
    conf_thres a float or a (B,) tensor. Returns (B, max_dets, ...)
    boxes, scores, classes (0, and -1 on padding) and the bool valid
    mask."""
    conf = torch.as_tensor(conf_thres, dtype=torch.float32,
                           device=boxes.device).reshape(-1, 1)
    gated = torch.where(scores >= conf, scores, NEG_INF)
    top_scores, top_idx = _top_k_padded(gated, pre_nms)
    sel = _rows(boxes, top_idx)
    keep = rotated_nms_padded(sel, top_scores, iou_thres=iou_thres,
                              block=block)
    final = torch.where(keep, top_scores, NEG_INF)
    out_scores, order = top_k(final, max_dets)
    out_valid = out_scores > NEG_INF / 2
    zero = torch.zeros((), dtype=torch.int32, device=boxes.device)
    return {
        "boxes": torch.where(out_valid[..., None], _rows(sel, order), 0.0),
        "scores": torch.where(out_valid, out_scores, 0.0),
        "classes": torch.where(out_valid, zero, zero - 1),
        "valid": out_valid,
    }
