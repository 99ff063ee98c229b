"""Batched sketch augmentations on the device, drawn from a
``torch.Generator``.

Counterpart of ``art_sbir_tpu/ops/augment.py`` (reference
`transformations.py:18-55`): RandomPerspective + RandomAffine(scale)
together with p = 0.5, a second RandomAffine (rotate, translate, scale,
shear) with p = 0.5 (V2: p = 0.7 and wider ranges), then RandomErasing
with white. The parameters follow torchvision's samplers in distribution
(integer corner jitter, uniform angle/translate/scale/shear, log-uniform
erase aspect with 10 attempts); neither JAX's nor torchvision's random
streams are reproduced.

Every transform is one inverse-warp gather over the whole batch: a 3x3
output->input matrix per image, the pixel-index grid, ``round`` for
nearest and four taps for bilinear, white fill where a tap falls outside
the image. It is written as the JAX package writes it, so given the same
matrix the two give the same pixels; ``F.grid_sample`` takes other
coordinate and padding conventions. Perspective samples bilinear, affine
nearest (torchvision's defaults). Images are (B, H, W, C) float in
[0, 1], white background.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from art_sbir_tpu_torch.ops.resize import CLIP_MEAN, CLIP_STD, normalize


def _deg2rad(x: torch.Tensor) -> torch.Tensor:
    return x * (math.pi / 180.0)


def _rand(gen: torch.Generator, n: int) -> torch.Tensor:
    return torch.rand(n, generator=gen, device=gen.device)


def _uniform(gen: torch.Generator, n: int, lo, hi) -> torch.Tensor:
    return lo + (hi - lo) * _rand(gen, n)


def _draws(b: int, rows: Optional[Tuple[int, int]]) -> Tuple[int, slice]:
    """How many rows to draw for and which of them to keep: ``rows`` =
    (offset, total) places a rank's ``b`` rows in a global batch of
    ``total`` (data-parallel training draws for the global batch, from a
    generator that advances alike on every rank, and keeps its rows)."""
    if rows is None:
        return b, slice(0, b)
    return rows[1], slice(rows[0], rows[0] + b)


def _randint(gen: torch.Generator, shape, hi) -> torch.Tensor:
    """Integers uniform on [0, hi); ``hi`` an int or a tensor of ``shape``."""
    return torch.floor(torch.rand(shape, generator=gen, device=gen.device)
                       * hi).to(torch.int64)


# ---------------------------------------------------------------- warps


def warp_projective(img: torch.Tensor, h_inv: torch.Tensor,
                    method: str = "bilinear", fill: float = 1.0
                    ) -> torch.Tensor:
    """Inverse-warp (B, H, W, C) images, each by its (3, 3) output->input
    matrix of ``h_inv`` (B, 3, 3)."""
    b, h, w, _ = img.shape
    dev = img.device
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    grid = torch.stack([gx, gy, torch.ones_like(gx)])  # (3, H, W)
    v = torch.einsum("bij,jhw->bihw", h_inv.float(), grid)
    xi = v[:, 0] / v[:, 2]
    yi = v[:, 1] / v[:, 2]
    bi = torch.arange(b, device=dev)[:, None, None]

    def tap(yy, xx):
        inb = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        p = img[bi, yy.clamp(0, h - 1), xx.clamp(0, w - 1)]
        return torch.where(inb[..., None], p, torch.full_like(p, fill))

    if method == "nearest":
        return tap(torch.round(yi).to(torch.int64),
                   torch.round(xi).to(torch.int64))

    x0 = torch.floor(xi)
    y0 = torch.floor(yi)
    fx = (xi - x0)[..., None]
    fy = (yi - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    p00 = tap(y0i, x0i)
    p01 = tap(y0i, x0i + 1)
    p10 = tap(y0i + 1, x0i)
    p11 = tap(y0i + 1, x0i + 1)
    top = p00 * (1 - fx) + p01 * fx
    bot = p10 * (1 - fx) + p11 * fx
    return top * (1 - fy) + bot * fy


def affine_inverse_matrix(angle: torch.Tensor,
                          translate: Tuple[torch.Tensor, torch.Tensor],
                          scale: torch.Tensor,
                          shear: Tuple[torch.Tensor, torch.Tensor],
                          center: Tuple[float, float]) -> torch.Tensor:
    """(B, 3, 3) output->input matrices for rotate/translate/scale/shear
    about the image center (torchvision ``_get_inverse_affine_matrix``);
    every argument but ``center`` is a (B,) tensor."""
    rot = _deg2rad(angle)
    sx = _deg2rad(shear[0])
    sy = _deg2rad(shear[1])
    cx, cy = center
    tx, ty = translate

    a = torch.cos(rot - sy) / torch.cos(sy)
    b = -torch.cos(rot - sy) * torch.tan(sx) / torch.cos(sy) - torch.sin(rot)
    c = torch.sin(rot - sy) / torch.cos(sy)
    d = -torch.sin(rot - sy) * torch.tan(sx) / torch.cos(sy) + torch.cos(rot)

    # inverse of [[a, b], [c, d]] * scale
    m00, m01 = d / scale, -b / scale
    m10, m11 = -c / scale, a / scale
    # translation: x_in = M (x_out - c - t) + c
    m02 = cx - m00 * (cx + tx) - m01 * (cy + ty)
    m12 = cy - m10 * (cx + tx) - m11 * (cy + ty)
    zeros = torch.zeros_like(m00)
    ones = torch.ones_like(m00)
    return torch.stack([torch.stack([m00, m01, m02], -1),
                        torch.stack([m10, m11, m12], -1),
                        torch.stack([zeros, zeros, ones], -1)], -2)


def homography_from_points(src: torch.Tensor, dst: torch.Tensor
                           ) -> torch.Tensor:
    """(B, 3, 3) H with H @ [src, 1] ~ dst, from 4 point pairs, (B, 4, 2)
    each.

    The coordinates are scaled into about [0, 1] before the 8x8 solve, as
    the JAX package does (a float32 LU on the pixel-scale system loses
    about 2e-3 relative accuracy); H is then scaled back."""
    s = torch.clamp(torch.amax(torch.abs(torch.stack([src, dst], 1)),
                               dim=(1, 2, 3)), min=1.0)[:, None, None]
    src = src / s
    dst = dst / s
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    zeros, ones = torch.zeros_like(x), torch.ones_like(x)
    rows_u = torch.stack([x, y, ones, zeros, zeros, zeros, -u * x, -u * y], -1)
    rows_v = torch.stack([zeros, zeros, zeros, x, y, ones, -v * x, -v * y], -1)
    a = torch.stack([rows_u, rows_v], 2).reshape(-1, 8, 8)  # rows u0, v0, ...
    h8 = torch.linalg.solve(a, dst.reshape(-1, 8))
    h = torch.cat([h8, torch.ones_like(h8[:, :1])], 1).reshape(-1, 3, 3)
    # undo the scaling: H = D Hn D^-1 with D = diag(s, s, 1)
    sv = s[:, 0, 0]
    scale = torch.ones_like(h)
    scale[:, 0:2, 2] = sv[:, None]
    scale[:, 2, 0:2] = 1.0 / sv[:, None]
    return h * scale


# ------------------------------------------------- parameter samplers


def perspective_endpoints(gen: torch.Generator, n: int, h: int, w: int,
                          distortion_scale: float
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """torchvision ``RandomPerspective.get_params``, integer corner jitter:
    the start corners (4, 2) and ``n`` end corner sets (n, 4, 2) in the
    order tl, tr, br, bl."""
    dw = int(distortion_scale * (w // 2)) + 1
    dh = int(distortion_scale * (h // 2)) + 1
    j = _randint(gen, (8, n), torch.tensor(
        [dw, dh] * 4, device=gen.device)[:, None]).float()
    tl = torch.stack([j[0], j[1]], -1)
    tr = torch.stack([w - 1 - j[2], j[3]], -1)
    br = torch.stack([w - 1 - j[4], h - 1 - j[5]], -1)
    bl = torch.stack([j[6], h - 1 - j[7]], -1)
    start = torch.tensor([[0.0, 0.0], [w - 1, 0.0], [w - 1, h - 1],
                          [0.0, h - 1]], device=gen.device)
    return start, torch.stack([tl, tr, br, bl], 1)


class AffineRanges(NamedTuple):
    degrees: float = 0.0
    translate: float = 0.0
    scale: Tuple[float, float] = (1.0, 1.0)
    shear: float = 0.0


def affine_params(gen: torch.Generator, n: int, h: int, w: int,
                  r: AffineRanges):
    """torchvision ``RandomAffine.get_params`` distributions, ``n`` draws:
    angle, (tx, ty), scale, (shear_x, shear_y), each (n,)."""
    angle = _uniform(gen, n, -r.degrees, r.degrees)
    max_dx, max_dy = r.translate * w, r.translate * h
    tx = torch.round(_uniform(gen, n, -max_dx, max_dx))
    ty = torch.round(_uniform(gen, n, -max_dy, max_dy))
    scale = _uniform(gen, n, r.scale[0], r.scale[1])
    shx = _uniform(gen, n, -r.shear, r.shear)
    shy = _uniform(gen, n, -r.shear, r.shear)
    return angle, (tx, ty), scale, (shx, shy)


def erase_params(gen: torch.Generator, n: int, h: int, w: int,
                 scale: Tuple[float, float],
                 ratio: Tuple[float, float] = (0.3, 3.3), attempts: int = 10):
    """torchvision ``RandomErasing.get_params``, ``n`` draws: 10 attempts,
    the first that fits wins. Returns (i, j, eh, ew, found), each (n,);
    where no attempt fits, ``found`` is False and the erase does nothing
    (torchvision returns the image unchanged)."""
    shape = (n, attempts)
    area = h * w
    ea = area * _uniform(gen, n * attempts, scale[0], scale[1]).reshape(shape)
    logr = _uniform(gen, n * attempts, math.log(ratio[0]),
                    math.log(ratio[1])).reshape(shape)
    ar = torch.exp(logr)
    eh = torch.round(torch.sqrt(ea * ar)).to(torch.int64)
    ew = torch.round(torch.sqrt(ea / ar)).to(torch.int64)
    ok = (eh < h) & (ew < w) & (eh > 0) & (ew > 0)
    i = _randint(gen, shape, torch.clamp(h - eh + 1, min=1))
    j = _randint(gen, shape, torch.clamp(w - ew + 1, min=1))
    first = torch.argmax(ok.to(torch.int8), dim=1, keepdim=True)
    pick = lambda t: torch.gather(t, 1, first)[:, 0]  # noqa: E731
    return pick(i), pick(j), pick(eh), pick(ew), ok.any(dim=1)


def apply_erase(img: torch.Tensor, gen: torch.Generator, p: float, scale,
                ratio=(0.3, 3.3), value: float = 1.0,
                rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """One RandomErasing pass on (B, H, W, C), a coin and a box per image
    (``rows``: see :func:`_draws`)."""
    b, h, w, _ = img.shape
    n, keep = _draws(b, rows)
    do = (_rand(gen, n) < p)[keep]
    i, j, eh, ew, found = (t[keep] for t in
                           erase_params(gen, n, h, w, scale, ratio))
    gy = torch.arange(h, device=img.device)[None, :, None]
    gx = torch.arange(w, device=img.device)[None, None, :]
    col = lambda t: t[:, None, None]  # noqa: E731
    inside = ((gy >= col(i)) & (gy < col(i + eh)) & (gx >= col(j))
              & (gx < col(j + ew)))
    sel = inside & col(do & found)
    return torch.where(sel[..., None], torch.full_like(img, value), img)


# --------------------------------------------------------- pipelines


def _where(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor
           ) -> torch.Tensor:
    """Per-image select: ``cond`` (B,) picks ``a`` over ``b``."""
    return torch.where(cond[:, None, None, None], a, b)


def _keep_affine(params, keep: slice):
    angle, (tx, ty), sc, (shx, shy) = params
    return angle[keep], (tx[keep], ty[keep]), sc[keep], (shx[keep],
                                                         shy[keep])


def sketch_augment(batch: torch.Tensor, gen: torch.Generator,
                   version: int = 1, do_normalize: bool = True,
                   rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Batched sketch augmentation, (B, H, W, C) in [0, 1] -> augmented
    (and CLIP-normalized), replacing reference ``sketch_transformV1/V2``.
    ``rows`` = (offset, total): the batch is a rank's rows of a global
    batch of ``total``, whose draws are made (:func:`_draws`)."""
    b, h, w, _ = batch.shape
    n, keep = _draws(b, rows)
    center = ((w - 1) * 0.5, (h - 1) * 0.5)
    if version == 1:
        distortion, p1 = 0.3, 0.5
        aff2 = AffineRanges(degrees=15.0, translate=0.1, scale=(0.9, 1.1),
                            shear=7.0)
        p2 = 0.5
        erases = [(0.5, (0.05, 0.2), (0.3, 3.3))]
    elif version == 2:
        distortion, p1 = 0.35, 0.5
        aff2 = AffineRanges(degrees=15.0, translate=0.3, scale=(0.8, 1.2),
                            shear=10.0)
        p2 = 0.7
        erases = [(0.7, (0.05, 0.1), (0.3, 3.3)),
                  (0.7, (0.05, 0.1), (0.2, 2.0)),
                  (0.7, (0.05, 0.1), (0.4, 4.0))]
    else:
        raise ValueError(f"unknown augmentation version {version}")
    img = batch

    # group 1 (p = 0.5): perspective (bilinear), then affine scale (nearest)
    apply1 = (_rand(gen, n) < p1)[keep]
    start, end = perspective_endpoints(gen, n, h, w, distortion)
    end = end[keep]
    h_inv = homography_from_points(end, start.expand_as(end))  # out -> in
    out = warp_projective(img, h_inv, "bilinear", fill=1.0)
    angle, tr, sc, sh = _keep_affine(
        affine_params(gen, n, h, w, AffineRanges(scale=(1.05, 1.3))), keep)
    out = warp_projective(out, affine_inverse_matrix(angle, tr, sc, sh,
                                                     center),
                          "nearest", fill=1.0)
    img = _where(apply1, out, img)

    # group 2: full affine (nearest)
    apply2 = (_rand(gen, n) < p2)[keep]
    angle, tr, sc, sh = _keep_affine(affine_params(gen, n, h, w, aff2), keep)
    out2 = warp_projective(img, affine_inverse_matrix(angle, tr, sc, sh,
                                                      center),
                           "nearest", fill=1.0)
    img = _where(apply2, out2, img)

    for pe, sce, rat in erases:
        img = apply_erase(img, gen, pe, sce, rat, value=1.0, rows=rows)
    return normalize(img, CLIP_MEAN, CLIP_STD) if do_normalize else img


def paired_hflip(gen: torch.Generator, sketch: torch.Tensor,
                 pos: torch.Tensor, neg: torch.Tensor, p: float = 0.5,
                 rows: Optional[Tuple[int, int]] = None):
    """AugmentedKaggle's paired flip: one coin for (sketch, pos), another
    for neg (reference `data_preparation.py:644-657`); ``rows``: see
    :func:`_draws`."""
    n, keep = _draws(sketch.shape[0], rows)
    f1 = (_rand(gen, n) < p)[keep]
    f2 = (_rand(gen, n) < p)[keep]
    flip = lambda x, f: _where(f, torch.flip(x, dims=(2,)), x)  # noqa: E731
    return flip(sketch, f1), flip(pos, f1), flip(neg, f2)
