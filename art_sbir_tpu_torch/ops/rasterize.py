"""Batched stroke rasterization on tensors, on the caller's device.

Counterpart of ``art_sbir_tpu/ops/rasterize.py``. The reference draws each
sketch with a per-pixel Python Bresenham loop inside ``__getitem__``
(reference `semiSupervised_utils/rasterize.py:131-149`); here a batch is
rasterized at once with no loop over pixels:

* :func:`prepare_points`: stroke-5 or stroke-3 -> absolute integer canvas
  points and a mask of the segments drawn (reference `to_normal_strokes`
  and `to_stroke_list`, `rasterize.py:154-191`): truncate at the end
  token, prepend the origin, cumsum, min/max-normalize into [30, 225] in
  float64 and take ``floor(scaled + 1e-9)`` with JAX's two-sided
  correction (JAX ``rasterize.py:83-100``);
* :func:`rasterize_points`: the dense Bresenham coverage test. Every
  (pixel, segment) pair is tested against the closed form of the
  Bresenham recurrence: along the driving axis, step j selects the minor
  coordinate ``m(j) = floor((2 a_minor j + a_major) / (2 a_major))``,
  tested as the band ``den m <= num < den m + den``. Segments go in
  chunks of 16; the offsets along x and y are (.., 1, W) and (.., H, 1)
  tensors, so only the comparisons are (B, chunk, H, W), as bool;
* the 4-connected cross dilation (scipy's default structure) on top.

:func:`prepare_points_host` is JAX's float64 host form, which truncates
with a plain ``astype(int32)`` (JAX ``rasterize.py:237-238``); the catalog
caches its points and :func:`rasterize_prepared` draws them. Row and
column 0 are never drawn (the reference's bound check, `rasterize.py:141`).
Everything here is integer logic after the float64 scaling, so results
are exact on every device: the native C++ rasterizer
(:mod:`art_sbir_tpu_torch.ops.raster_native`) and JAX's oracle
(``ops/raster_reference.py``) give the same canvases.
"""

from __future__ import annotations

import numpy as np
import torch

from art_sbir_tpu_torch.ops.dilate import binary_dilate_cross

CANVAS = 256
LO, HI = 30.0, 225.0
SEG_CHUNK = 16  # segments a coverage test: (B, 16, 256, 256) bool at once


def prepare_points(batch: torch.Tensor):
    """(B, T, 5) or (B, T, 3) strokes -> ((B, T + 1, 2) int32 points,
    (B, T) bool segments drawn). Segment i joins point i to point i + 1.
    With stroke-5 the last row is ``argmax(end)``, or ``T - 1`` where no
    row ends or the first end sits at row 0."""
    b, t, ch = batch.shape
    dev = batch.device
    rows = torch.arange(t, device=dev)[None]
    if ch == 5:
        end = batch[..., 4] > 0
        idx = torch.argmax(end.to(torch.int32), dim=1)
        last = torch.where(end.any(1) & (idx > 0), idx, t - 1)[:, None]
        pen = torch.where(rows == last, torch.ones_like(batch[..., 3]),
                          batch[..., 3])
    else:
        last = torch.full((b, 1), t - 1, device=dev)
        pen = batch[..., 2]
    valid = rows <= last  # (B, T)

    xy = torch.where(valid[..., None], batch[..., :2],
                     torch.zeros_like(batch[..., :2])).to(torch.float64)
    pts = torch.cumsum(torch.cat([xy.new_zeros(b, 1, 2), xy], dim=1), dim=1)
    valid_ext = torch.cat([valid.new_ones(b, 1), valid], dim=1)[..., None]
    lo = torch.where(valid_ext, pts, torch.full_like(pts, 1e30)).amin(1)
    hi = torch.where(valid_ext, pts, torch.full_like(pts, -1e30)).amax(1)
    span = torch.where(hi - lo > 0, hi - lo, torch.ones_like(hi))
    scaled = (pts - lo[:, None]) / span[:, None] * (HI - LO) + LO
    # floor(scaled + 1e-9), with the correction JAX takes on every
    # backend (its TPU's float64 is emulated); scaled >= 30, so the cast
    # truncates to within one of the floor
    c0 = scaled.to(torch.int32)
    cf = c0.to(torch.float64)
    s9 = scaled + 1e-9
    ipts = c0 - (cf > s9).to(torch.int32) + (cf + 1.0 <= s9).to(torch.int32)

    pen_prev = torch.cat([pen.new_zeros(b, 1), pen[:, :-1]], dim=1)
    return ipts, valid & (pen_prev == 0)


def _segments_mask(p0: torch.Tensor, p1: torch.Tensor, draw: torch.Tensor,
                   gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """Coverage of a chunk of segments: p0, p1 (B, S, 2) int32, draw (B, S)
    -> (B, H, W) bool."""
    x0, y0 = p0[..., 0, None, None], p0[..., 1, None, None]  # (B, S, 1, 1)
    dx = p1[..., 0, None, None] - x0
    dy = p1[..., 1, None, None] - y0
    adx, ady = dx.abs(), dy.abs()
    ex = (gx - x0) * torch.where(dx > 0, 1, -1)  # (B, S, 1, W)
    ey = (gy - y0) * torch.where(dy > 0, 1, -1)  # (B, S, H, 1)

    def on_line(j, m, a_major, a_minor):
        """j along the driving axis, m the minor offset."""
        num = 2 * a_minor * j + a_major
        den = torch.clamp(2 * a_major, min=1)
        band = den * m
        return ((j >= 0) & (j <= a_major) & (band <= num)
                & (num < band + den))

    on = torch.where(adx > ady, on_line(ex, ey, adx, ady),
                     on_line(ey, ex, ady, adx))
    return (on & draw[..., None, None]).any(dim=1)


def rasterize_points(points: torch.Tensor, seg_draw: torch.Tensor,
                     side: int = CANVAS) -> torch.Tensor:
    """(B, N, 2) int points and (B, N - 1) segments drawn -> (B, side,
    side) bool, ``SEG_CHUNK`` segments at a time."""
    b, n, _ = points.shape
    dev = points.device
    gx = torch.arange(side, device=dev, dtype=torch.int32).view(1, 1, 1, side)
    gy = gx.view(1, 1, side, 1)
    points = points.to(torch.int32)
    canvas = torch.zeros(b, side, side, dtype=torch.bool, device=dev)
    for s in range(0, n - 1, SEG_CHUNK):
        e = min(s + SEG_CHUNK, n - 1)
        canvas |= _segments_mask(points[:, s:e], points[:, s + 1:e + 1],
                                 seg_draw[:, s:e], gx, gy)
    return canvas & ((gx > 0) & (gy > 0))[0]


def prepare_points_host(batch):
    """JAX's float64 host form of :func:`prepare_points` (numpy; the
    reference's own scaling, `rasterize.py:170-191`), which truncates with
    ``astype(int32)``: the catalogs cache its points for
    :func:`rasterize_prepared`. (B, T, 5|3) -> ((B, T + 1, 2) int32,
    (B, T) bool), numpy arrays."""
    batch = np.asarray(batch, np.float64)
    b, t, ch = batch.shape
    pts_out = np.zeros((b, t + 1, 2), np.int32)
    seg_out = np.zeros((b, t), bool)
    rows = np.arange(t)
    for i in range(b):
        stroke = batch[i]
        if ch == 5:
            end = stroke[:, 4] > 0
            idx = int(np.argmax(end))
            last = idx if (end.any() and idx > 0) else t - 1
            pen = stroke[:, 3].copy()
            pen[last] = 1.0
        else:
            last = t - 1
            pen = stroke[:, 2]
        valid = rows <= last
        xy = np.where(valid[:, None], stroke[:, :2], 0.0)
        pts = np.concatenate([np.zeros((1, 2)), xy]).cumsum(axis=0)
        vext = np.concatenate([[True], valid])
        lo = pts[vext].min(axis=0)
        hi = pts[vext].max(axis=0)
        span = np.where(hi - lo > 0, hi - lo, 1.0)
        scaled = (pts - lo) / span * (HI - LO) + LO
        pts_out[i] = scaled.astype(np.int32)
        pen_ext = np.concatenate([[0.0], pen])
        seg_out[i] = valid & (pen_ext[:-1] == 0)
    return pts_out, seg_out


def rasterize_prepared(points: torch.Tensor, seg_draw: torch.Tensor
                       ) -> torch.Tensor:
    """Cached integer points (:func:`prepare_points_host`) -> (B, 256, 256)
    float32 canvases, 0 or 255, dilated."""
    canvas = binary_dilate_cross(rasterize_points(points, seg_draw))
    return canvas.to(torch.float32) * 255.0


def rasterize_strokes(batch: torch.Tensor) -> torch.Tensor:
    """(B, T, 5|3) strokes -> (B, 256, 256) float32 canvases, 0 or 255
    (reference `batch_rasterize_relative`, `rasterize.py:152-205`)."""
    return rasterize_prepared(*prepare_points(batch))
