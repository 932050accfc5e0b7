"""Vision ops for the tracker: normalization, bilinear sampling, window
extraction and ROI pooling — the port of the JAX package's ``ops/image.py``.

Arbitrary float window positions and sizes are handled by resampling onto a
fixed grid. ``bilinear_sample`` gathers 4 taps per point; the ``*_mxu``
functions write the same interpolation as a dense "hat weight" matrix,
W[i, r] = max(0, 1 - |t_i - r|), so a resample is two matrix products and
ROI pooling is a weighted sum over the token grid. Windows, boxes and
feature grids take optional leading axes (K filter banks, each with its own
window; with a frame of its own in multi-stream tracking).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@functools.lru_cache(maxsize=None)
def imagenet_stats(dtype: torch.dtype, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean [3], std [3]) in `dtype` on `device`, built once each: a copy
    from host memory inside a tracker step would be a wait for the card, and
    is not allowed in a captured CUDA graph. Callers must not write to them."""
    return (torch.tensor(IMAGENET_MEAN, dtype=dtype, device=device),
            torch.tensor(IMAGENET_STD, dtype=dtype, device=device))


def normalize_frame(frame: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 [H, W, 3] -> normalized float [H, W, 3]."""
    x = frame.to(dtype) / 255.0
    mean, std = imagenet_stats(dtype, frame.device)
    return (x - mean) / std


def bilinear_sample(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Sample img [H, W, C] at float coords (ys, xs) [...], clamp-to-edge.

    Coordinates are pixel-centred: (0, 0) is the centre of the top-left
    pixel. Returns [..., C]: 4 taps at floor(t) and min(floor(t) + 1, size - 1)
    per axis, then the lerp, in the JAX package's order of operations.
    Images [*F, H, W, C] with coords [*F, ...] sample each image at its own
    coords.
    """
    h, w = img.shape[-3], img.shape[-2]
    lead = img.shape[:-3]
    ys = torch.clamp(ys, 0.0, h - 1.0)
    xs = torch.clamp(xs, 0.0, w - 1.0)
    y0f = torch.floor(ys)
    x0f = torch.floor(xs)
    wy = (ys - y0f)[..., None]
    wx = (xs - x0f)[..., None]
    y0 = y0f.to(torch.int64)
    x0 = x0f.to(torch.int64)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    flat = img.reshape(-1, img.shape[-1])
    if lead:
        # Row offset of each image in `flat`, broadcast over its coords.
        base = torch.arange(flat.shape[0] // (h * w), device=img.device).reshape(*lead, *[1] * (ys.dim() - len(lead)))
        y0, y1 = y0 + base * h, y1 + base * h

    def take(yi, xi):
        return flat[yi * w + xi]

    v00, v01 = take(y0, x0), take(y0, x1)
    v10, v11 = take(y1, x0), take(y1, x1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def hat_weights(coords: torch.Tensor, size: int, dtype=torch.float32) -> torch.Tensor:
    """Bilinear interpolation as a matrix: [..., M] coords -> [..., M, size].

    Coords are clamped to [0, size-1]; each row has at most two nonzeros
    summing to 1.
    """
    t = torch.clamp(coords.to(dtype), 0.0, size - 1.0)
    r = torch.arange(size, dtype=dtype, device=coords.device)
    return torch.clamp(1.0 - torch.abs(t[..., None] - r), min=0.0)


def _offsets(out_size: int, device) -> torch.Tensor:
    """Sample offsets (i + 0.5)/out - 0.5 in [-0.5, 0.5), f32."""
    return (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) / out_size - 0.5


def extract_window_mxu(
    img: torch.Tensor, center: torch.Tensor, side: torch.Tensor, out_size: int
) -> torch.Tensor:
    """Separable bilinear resample of square windows: [H, W, C] ->
    [..., out, out, C] for centers [..., 2] (one window for a [2] center, G
    of them in one batched product for [G, 2]). `side` is a scalar or has
    leading axes of the centers' (one side a bank of windows: [K] for
    centers [K, 2] or [K, G, 2]). Images [*F, H, W, C] give each leading
    index of the centers its own image (centers [*F, ..., 2])."""
    h, w, c = img.shape[-3:]
    frames = img.shape[:-3]
    lead = center.shape[:-1]
    t = _offsets(out_size, img.device)
    side = side.reshape(*side.shape, *[1] * (len(lead) - side.dim() + 1))
    wy = hat_weights(center[..., 1:2] + side * t, h)  # [..., out, H]
    wx = hat_weights(center[..., 0:1] + side * t, w)  # [..., out, W]
    # Every window's rows of one image in one product: [*F, rows, H] @ [*F, H, W*C].
    a = wy.reshape(*frames, -1, h) @ img.reshape(*frames, h, w * c)
    a = a.reshape(*lead, out_size, w, c).transpose(-1, -2).reshape(*lead, out_size * c, w)
    b = a @ wx.transpose(-1, -2)  # [..., out*C, out]
    return b.reshape(*lead, out_size, c, out_size).transpose(-1, -2)


class FrameView(NamedTuple):
    """A (possibly cropped and decimated) view of a frame.

    Tracker math stays in full-frame pixel coordinates; only sampling maps
    through the view: view_px = (frame_px - origin) / stride.
    pixels: [h, w, 3] float (0..255 scale); origin: [2] f32 (x0, y0).
    """

    pixels: torch.Tensor
    origin: torch.Tensor
    stride: float = 1.0


class StreamFrame(NamedTuple):
    """A step's input on the ROI streaming path.

    track: a crop around the predicted target (stride 1, a strided slice,
        or a resampled view at a fractional stride): what each frame ships.
    glob: the whole frame decimated (stride >> 1), refreshed every few
        frames and reused on the device in between: global re-detection
        scans it, and it gives the frame's bounds.
    A chunk of C frames stacks C tracking views (pixels [C, h, w, 3],
    origins [C, 2], one stride) over one glob view. Each stride is a Python
    float, fixed for a stream: on the card it is part of the step graph's key.
    """

    track: FrameView
    glob: FrameView


def full_view(frame_f32: torch.Tensor) -> FrameView:
    """The whole frame as a view (origin 0, stride 1)."""
    return FrameView(
        pixels=frame_f32,
        origin=torch.zeros(2, dtype=torch.float32, device=frame_f32.device),
        stride=1.0,
    )


def view_extract_window_mxu(
    view: FrameView, center: torch.Tensor, side: torch.Tensor, out_size: int
) -> torch.Tensor:
    """extract_window_mxu through a FrameView (frame-coord centers [..., 2]
    and side)."""
    inv = 1.0 / float(view.stride)
    return extract_window_mxu(view.pixels, (center - view.origin) * inv, side * inv, out_size)


def window_grid(
    center: torch.Tensor, side: torch.Tensor, out_size: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample coords (ys, xs) [out, out] of a square window in source pixels."""
    t = _offsets(out_size, center.device)
    ys = center[1] + side * t
    xs = center[0] + side * t
    return ys[:, None].expand(out_size, out_size), xs[None, :].expand(out_size, out_size)


def extract_window(
    img: torch.Tensor, center: torch.Tensor, side: torch.Tensor, out_size: int
) -> torch.Tensor:
    """Resample a square window (any float center and side) to [out, out, C]
    by gathering; extract_window_mxu computes the same with two products."""
    ys, xs = window_grid(center, side, out_size)
    return bilinear_sample(img, ys, xs)


def frame_to_window_coords(
    pts_xy: torch.Tensor, center: torch.Tensor, side: torch.Tensor, out_size: int
) -> torch.Tensor:
    """Map frame-pixel (x, y) points [..., 2] into window-pixel coords."""
    return ((pts_xy - center) / side + 0.5) * out_size - 0.5


def _cell_coords(centers, sizes, grid):
    t = _offsets(grid, centers.device)
    ys = centers[..., 1:2] + sizes[..., 1:2] * t  # [..., N, K]
    xs = centers[..., 0:1] + sizes[..., 0:1] * t
    return ys, xs


def roi_cells_mxu(
    feat: torch.Tensor,  # [..., Gh, Gw, D]
    centers: torch.Tensor,  # [..., N, 2] grid coords (x, y)
    sizes: torch.Tensor,  # [..., N, 2] grid units (w, h)
    grid: int,
) -> torch.Tensor:
    """Per-cell ROI features without pooling -> [..., N, K, K, D]; leading
    axes batch feature grids with their own boxes."""
    gh, gw = feat.shape[-3:-1]
    ys, xs = _cell_coords(centers, sizes, grid)
    wy = hat_weights(ys, gh)  # [..., N, K, Gh]
    wx = hat_weights(xs, gw)  # [..., N, K, Gw]
    a = torch.einsum("...nkr,...rcd->...nkcd", wy, feat.float())  # [..., N, K, Gw, D]
    return torch.einsum("...njc,...nkcd->...nkjd", wx, a)  # [..., N, K(y), K(x), D]


def roi_cells_cos_mxu(
    feat: torch.Tensor,  # [..., Gh, Gw, D] window token features
    mean_emb: torch.Tensor | None,  # [..., D] window-mean embedding (None = no centering)
    tmpl: torch.Tensor,  # [..., K*K, D] per-cell L2-normalized template rows
    centers: torch.Tensor,  # [..., N, 2] grid coords (x, y)
    sizes: torch.Tensor,  # [..., N, 2] grid units (w, h)
    grid: int,
) -> torch.Tensor:
    """Fused structured-template cosine scores -> [..., N] (mean per-cell
    cosine); leading axes batch windows, each with its own template and boxes.

    Equal (up to sum order) to pooling the cells with roi_cells_mxu,
    centering, L2-normalizing and taking the dot with the template, but the
    [N, K, K, D] cells are never formed: each cell's dot with its template
    row and its squared norm are bilinear in the hat weights, so D collapses
    into the per-frame maps G = F'·tmplᵀ [P, C] and H = F'·F'ᵀ [P, P].
    Centering commutes into F' because every hat-weight row sums to 1.
    """
    gh, gw, d = feat.shape[-3:]
    lead = feat.shape[:-3]
    n = centers.shape[-2]
    c = grid * grid
    p = gh * gw
    f = feat.float().reshape(*lead, p, d)
    if mean_emb is not None:
        f = f - mean_emb.float()[..., None, :]
    g = f @ tmpl.float().reshape(*lead, c, d).transpose(-1, -2)  # [..., P, C]
    gram = f @ f.transpose(-1, -2)  # [..., P, P]

    ys, xs = _cell_coords(centers, sizes, grid)
    wy = hat_weights(ys, gh)  # [..., N, K, Gh]
    wx = hat_weights(xs, gw)  # [..., N, K, Gw]
    w2 = torch.einsum("...nkr,...njc->...nkjrc", wy, wx).reshape(*lead, n, c, p)  # [..., N, C, P]
    dot = torch.einsum("...ncp,...pc->...nc", w2, g)  # [..., N, C]
    u = torch.matmul(w2.reshape(*lead, n * c, p), gram).reshape(*lead, n, c, p)  # [..., N, C, P]
    nrm2 = torch.sum(u * w2, dim=-1)  # [..., N, C]
    # eps placement matches l2_normalize: v / (|v| + 1e-8).
    cos_c = dot / (torch.sqrt(torch.clamp(nrm2, min=0.0)) + 1e-8)
    return cos_c.mean(dim=-1)


def roi_pool_cos_mxu(
    feat: torch.Tensor,  # [..., Gh, Gw, D]
    mean_emb: torch.Tensor | None,  # [..., D]
    tmpl: torch.Tensor,  # [..., D] L2-normalized pooled template
    centers: torch.Tensor,  # [..., N, 2]
    sizes: torch.Tensor,  # [..., N, 2]
    grid: int,
) -> torch.Tensor:
    """Fused pooled-template cosine scores -> [..., N] (same Gram trick, one
    cell)."""
    gh, gw, d = feat.shape[-3:]
    lead = feat.shape[:-3]
    n = centers.shape[-2]
    p = gh * gw
    f = feat.float().reshape(*lead, p, d)
    if mean_emb is not None:
        f = f - mean_emb.float()[..., None, :]
    g = f @ tmpl.float()[..., None]  # [..., P, 1]
    gram = f @ f.transpose(-1, -2)  # [..., P, P]

    ys, xs = _cell_coords(centers, sizes, grid)
    ay = hat_weights(ys, gh).mean(dim=-2)  # [..., N, Gh]
    ax = hat_weights(xs, gw).mean(dim=-2)  # [..., N, Gw]
    w = torch.einsum("...nr,...nc->...nrc", ay, ax).reshape(*lead, n, p)  # [..., N, P]
    dot = (w @ g)[..., 0]  # [..., N]
    u = w @ gram  # [..., N, P]
    nrm2 = torch.sum(u * w, dim=-1)
    return dot / (torch.sqrt(torch.clamp(nrm2, min=0.0)) + 1e-8)


def roi_pool_mxu(
    feat: torch.Tensor,  # [..., Gh, Gw, D]
    centers: torch.Tensor,  # [..., N, 2]
    sizes: torch.Tensor,  # [..., N, 2]
    grid: int,
) -> torch.Tensor:
    """ROI-align mean pooling through per-axis averaged hat weights ->
    [..., N, D]; leading axes batch feature grids with their own boxes."""
    gh, gw, d = feat.shape[-3:]
    ys, xs = _cell_coords(centers, sizes, grid)
    ay = hat_weights(ys, gh).mean(dim=-2)  # [..., N, Gh]
    ax = hat_weights(xs, gw).mean(dim=-2)  # [..., N, Gw]
    s1 = ay @ feat.float().reshape(*feat.shape[:-3], gh, gw * d)  # [..., N, Gw*D]
    return torch.einsum("...nc,...ncd->...nd", ax, s1.reshape(*s1.shape[:-1], gw, d))
