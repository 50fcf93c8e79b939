"""Film: the image block, its reconstruction filters and develop (the JAX
package's `librender/film.py`).

The buffer is [H*W, C+1]; the last channel is the accumulated filter
weight. Three ways in:
- `put_ordered` (box filter, pixel-ordered lanes: lane i belongs to pixel
  i // spp, the camera layout of `integrators.common.sample_rays`): a
  reshape and a running sum, deterministic, no scatter;
- `put_ordered_filtered` (any filter, pixel-ordered lanes): per filter tap,
  the lanes' weights summed per pixel, then the image shifted by the tap;
  taps that fall outside the image drop;
- `put` (any lanes): a scatter by `index_add_`, not deterministic on the
  card.
Filters (radius in pixels): box 1, gaussian 2 (stddev 0.5 radius), tent 1,
mitchell and catmull-rom 2, lanczos 3."""
from __future__ import annotations

import dataclasses
import math

import torch

FILTER_BOX = 0
FILTER_GAUSSIAN = 1
FILTER_TENT = 2
FILTER_MITCHELL = 3
FILTER_CATMULLROM = 4
FILTER_LANCZOS = 5

FILTER_RADIUS = {
    FILTER_BOX: 1,
    FILTER_GAUSSIAN: 2,
    FILTER_TENT: 1,
    FILTER_MITCHELL: 2,
    FILTER_CATMULLROM: 2,
    FILTER_LANCZOS: 3,
}

FILTER_NAMES = {
    "box": FILTER_BOX, "gaussian": FILTER_GAUSSIAN, "tent": FILTER_TENT,
    "mitchell": FILTER_MITCHELL, "catmullrom": FILTER_CATMULLROM,
    "lanczos": FILTER_LANCZOS,
}

def filter_id(rfilter) -> int:
    """A filter's id from its id or its name; anything else raises."""
    if isinstance(rfilter, str):
        if rfilter not in FILTER_NAMES:
            raise ValueError(f"unknown reconstruction filter {rfilter!r}; "
                             f"one of {sorted(FILTER_NAMES)}")
        return FILTER_NAMES[rfilter]
    if int(rfilter) not in FILTER_RADIUS:
        raise ValueError(f"unknown reconstruction filter id {rfilter!r}")
    return int(rfilter)


def _mitchell_1d(x, B, C):
    x = torch.abs(x)
    x2 = x * x
    x3 = x2 * x
    inner = ((12 - 9 * B - 6 * C) * x3 + (-18 + 12 * B + 6 * C) * x2
             + (6 - 2 * B)) * (1.0 / 6.0)
    outer = ((-B - 6 * C) * x3 + (6 * B + 30 * C) * x2
             + (-12 * B - 48 * C) * x + (8 * B + 24 * C)) * (1.0 / 6.0)
    return torch.where(x < 1.0, inner, torch.where(x < 2.0, outer, 0.0))


def filter_eval(rfilter: int, x):
    """The 1D reconstruction filter at offset x (pixels)."""
    if rfilter == FILTER_GAUSSIAN:
        sigma2 = 1.0  # (radius / 2)^2 with radius 2
        v = torch.exp(-0.5 * x * x / sigma2) - math.exp(-2.0 / sigma2)
        return torch.clamp_min(v, 0.0)
    if rfilter == FILTER_TENT:
        return torch.clamp_min(1.0 - torch.abs(x), 0.0)
    if rfilter == FILTER_MITCHELL:
        return _mitchell_1d(x, 1.0 / 3.0, 1.0 / 3.0)
    if rfilter == FILTER_CATMULLROM:
        return _mitchell_1d(x, 0.0, 0.5)
    if rfilter == FILTER_LANCZOS:
        ax = torch.abs(x)
        big = ax > 1e-6
        pix = math.pi * torch.where(big, x, 1.0)
        sinc = torch.where(big, torch.sin(pix) / pix, 1.0)
        pix3 = pix / 3.0
        sinc3 = torch.where(big, torch.sin(pix3) / pix3, 1.0)
        return torch.where(ax < 3.0, sinc * sinc3, 0.0)
    return torch.where(torch.abs(x) <= 0.5, 1.0, 0.0)  # box


def _payload(values, active):
    """[N, C+1]: the values where active and finite, else 0, and the
    weight 1 or 0."""
    if active is None:
        active = torch.ones(values.shape[:1], dtype=torch.bool,
                            device=values.device)
    active = active & torch.all(torch.isfinite(values), dim=-1)
    vals = torch.where(active[..., None], values, 0.0)
    return torch.cat([vals, active.to(vals.dtype)[..., None]], -1), active


def _shift_slices(d, size):
    """(source, destination) slices along an axis of `size` of the image
    shifted by d pixels: pixel p's tap lands on p + d, or drops."""
    return (slice(max(-d, 0), size + min(-d, 0)),
            slice(max(d, 0), size + min(d, 0)))


@dataclasses.dataclass
class ImageBlock:
    data: torch.Tensor  # [H*W, C+1]
    width: int
    height: int
    n_channels: int
    rfilter: int = FILTER_BOX

    @staticmethod
    def create(width, height, n_channels, device, rfilter=FILTER_BOX):
        return ImageBlock(
            data=torch.zeros((width * height, n_channels + 1),
                             dtype=torch.float32, device=device),
            width=width, height=height, n_channels=n_channels,
            rfilter=filter_id(rfilter),
        )

    def put_ordered(self, values, active, spp: int):
        """Accumulate values [N, C] of pixel-ordered lanes into the buffer
        (in place), box filter; non-finite or inactive lanes count neither
        value nor weight. A pixel's samples are added in sample order, by
        one running sum along the sample axis (a scan over a middle axis
        adds each column in order on the CPU and the card alike), so a
        channel's sum does not depend on how many channels there are; a
        reduction's order may."""
        payload, _ = _payload(values, active)
        self.data += payload.reshape(self.width * self.height, spp,
                                     -1).cumsum(dim=1)[:, -1]
        return self

    def put_ordered_filtered(self, pos_uv, values, active, spp: int,
                             abs_weights: bool = False):
        """Accumulate values [N, C] of pixel-ordered lanes at film positions
        pos_uv [N, 2] through the block's filter (in place): for each tap
        (dx, dy) of the (2r+1)^2 around a lane's own pixel, the weight
        f(dx - jx) f(dy - jy) of its subpixel offset j, summed over each
        pixel's lanes, lands on the pixel shifted by the tap; taps outside
        the image drop. The lanes keep their layout, [H*W, spp, C+1]; the
        filter's 2r+1 weights along each axis are evaluated once.
        abs_weights splats |f| in place of f: with |values| it gives the
        sum of the terms' magnitudes, which bounds the rounding of the sum
        of filters with negative lobes (mitchell, catmull-rom, lanczos)."""
        w, h = self.width, self.height
        payload, _ = _payload(values, active)
        lane = torch.arange(values.shape[0], device=values.device) // spp
        jx = pos_uv[..., 0] * w - 0.5 - (lane % w).to(torch.float32)
        jy = pos_uv[..., 1] * h - 0.5 - (lane // w).to(torch.float32)
        taps = range(-FILTER_RADIUS[self.rfilter],
                     FILTER_RADIUS[self.rfilter] + 1)
        c1 = payload.shape[-1]

        def weights(j):
            out = [filter_eval(self.rfilter, d - j) for d in taps]
            return [x.abs() for x in out] if abs_weights else out

        wxs, wys = weights(jx), weights(jy)
        acc = torch.zeros((h, w, c1), device=values.device)
        for iy, dy in enumerate(taps):
            ysrc, ydst = _shift_slices(dy, h)
            for ix, dx in enumerate(taps):
                tap = (payload * (wxs[ix] * wys[iy])[..., None]).reshape(
                    h * w, spp, c1).sum(dim=1).reshape(h, w, c1)
                xsrc, xdst = _shift_slices(dx, w)
                acc[ydst, xdst] += tap[ysrc, xsrc]
        self.data += acc.reshape(h * w, c1)
        return self

    def put(self, pos_uv, values, active=None):
        """Splat values [N, C] of lanes in any order at film positions
        pos_uv [N, 2] in [0, 1]^2 (in place), by a scatter: the box filter
        into the nearest pixel, any other over the (2r)^2 pixels around
        the lane, each tap weighted f(x) f(y) and dropped outside."""
        w, h = self.width, self.height
        payload, active = _payload(values, active)
        px = pos_uv[..., 0] * w - 0.5  # continuous pixel coordinates
        py = pos_uv[..., 1] * h - 0.5
        if self.rfilter == FILTER_BOX:
            ix = torch.clamp(torch.round(px).to(torch.int64), 0, w - 1)
            iy = torch.clamp(torch.round(py).to(torch.int64), 0, h - 1)
            self.data.index_add_(0, iy * w + ix, payload)
            return self
        return self._put_splat(px, py, payload, active)

    def _put_splat(self, px, py, payload, active):
        w, h = self.width, self.height
        radius = FILTER_RADIUS[self.rfilter]
        base_x = torch.floor(px).to(torch.int64)
        base_y = torch.floor(py).to(torch.int64)
        for dy in range(-radius + 1, radius + 1):
            iy = base_y + dy
            wy = filter_eval(self.rfilter, iy.to(torch.float32) - py)
            for dx in range(-radius + 1, radius + 1):
                ix = base_x + dx
                wgt = filter_eval(self.rfilter,
                                  ix.to(torch.float32) - px) * wy
                inb = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
                wgt = torch.where(inb & active, wgt, 0.0)
                flat = (torch.clamp(iy, 0, h - 1) * w
                        + torch.clamp(ix, 0, w - 1))
                self.data.index_add_(0, flat, payload * wgt[..., None])
        return self

    def merge(self, other: "ImageBlock") -> "ImageBlock":
        """A block holding both blocks' sums."""
        return dataclasses.replace(self, data=self.data + other.data)

    def develop(self):
        """-> [H, W, C] image: value / weight."""
        img = self.data[..., :-1] / torch.clamp_min(self.data[..., -1:], 1e-8)
        return img.reshape(self.height, self.width, self.n_channels)
