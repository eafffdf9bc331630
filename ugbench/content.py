"""The camera's picture: a ring of UYVY frames made on the device from a seed.

A "world" picture larger than the frame is made once from a few large
``torch.randn`` calls on one ``torch.Generator``: smooth gradients, three
octaves of upsampled noise (structures of about 64, 16 and 4 pixels), and
low-amplitude per-pixel noise, in limited-range YCbCr.  Frame i of the ring
is a window of it panned ``pan`` pixels right and half as many down per
frame, so consecutive frames differ as a camera's shot does and every seed
has the same statistics (the same coded size, within a fraction of a
percent), in another arrangement.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

RING = 60  # distinct frames: one second of a 60 frames/s camera
PAN = 4  # pixels right per frame (even: UYVY pairs stay whole)


def _octave(gen, h: int, w: int, cell: int, amp: float, device) -> torch.Tensor:
    """Noise on a grid of ``cell`` pixels, bicubically upsampled to [h, w]."""
    gh, gw = -(-h // cell) + 3, -(-w // cell) + 3
    g = torch.randn(1, 1, gh, gw, generator=gen, device=device)
    up = F.interpolate(g, size=(gh * cell, gw * cell), mode="bicubic", align_corners=False)
    return amp * up[0, 0, cell: cell + h, cell: cell + w]


def _plane(gen, h: int, w: int, scale: float, device) -> torch.Tensor:
    """One plane of the world, float32, around 0: a gradient, three octaves
    and pixel noise, each scaled by ``scale``."""
    a = torch.rand(2, generator=gen, device=device) * 2 - 1
    yy = torch.linspace(-1, 1, h, device=device)[:, None]
    xx = torch.linspace(-1, 1, w, device=device)[None, :]
    p = 30.0 * (a[0] * xx + a[1] * yy)
    for cell, amp in ((64, 22.0), (16, 16.0), (4, 10.0)):
        p = p + _octave(gen, h, w, cell, amp, device)
    p = p + 3.0 * torch.randn(h, w, generator=gen, device=device)
    return scale * p


def ring(seed: int, width: int, height: int, n: int = RING, device="cuda") -> torch.Tensor:
    """uint8 [n, height, 2 * width] UYVY frames: window i of the world
    starts ``PAN * i`` pixels right and ``PAN * i // 2`` down."""
    if width % 2:
        raise ValueError("UYVY needs an even width")
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    ww = width + PAN * n
    wh = height + PAN * n // 2
    y = (128.0 + _plane(gen, wh, ww, 1.0, device)).clamp(16, 235)
    cb = (128.0 + _plane(gen, wh, ww // 2, 0.5, device)).clamp(16, 240)
    cr = (128.0 + _plane(gen, wh, ww // 2, 0.5, device)).clamp(16, 240)
    world = torch.empty(wh, 2 * ww, dtype=torch.uint8, device=device)
    world[:, 1::2] = y.round().to(torch.uint8)
    world[:, 0::4] = cb.round().to(torch.uint8)
    world[:, 2::4] = cr.round().to(torch.uint8)
    out = torch.empty(n, height, 2 * width, dtype=torch.uint8, device=device)
    for i in range(n):
        x0, y0 = PAN * i, PAN * i // 2
        out[i] = world[y0: y0 + height, 2 * x0: 2 * (x0 + width)]
    return out
