"""Integral images (Viola-Jones Eq. 3): the plain PyTorch layer.

``integral_image`` returns the padded summed-area table (SAT) of shape
(..., H+1, W+1) with a zero top row and left column, so the sum over the
half-open rectangle ``[y0, y0+h) x [x0, x0+w)`` is
``ii[y0+h, x0+w] - ii[y0, x0+w] - ii[y0+h, x0] + ii[y0, x0]``.

One pinned summation order.  The reference uses ``jnp.cumsum``, whose
float32 bits depend on XLA's scan.  The port pins its own: a column
cumsum, then a row cumsum, each accumulated in float64 and rounded to
float32 per entry.  That is what ``torch.cumsum`` does on the CPU for
float32, and what the port's CUDA SAT kernel (kernel S,
``repro_torch/csrc/integral_image.cu``) does on the card; for
integer-valued images the float64 sums are exact, so the result does not
depend on the device's scan order at all.  The port's SATs therefore agree
with the reference to tolerance, not bit for bit, and agree with each
other bit for bit.

The squared and centred tables use the fixed centre ``CENTRE = 128``
(window-local normalization; see ``repro.core.integral``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["CENTRE", "integral_image", "integral_images", "rect_sum",
           "div_rn", "inv_sigma_of", "window_inv_sigma", "integral_value"]

CENTRE = 128.0


def integral_image(img: torch.Tensor) -> torch.Tensor:
    """Padded SAT (..., H+1, W+1), float32, in the port's pinned order."""
    x = img.to(torch.float32)
    cols = torch.cumsum(x.double(), dim=-2).float()
    ii = torch.cumsum(cols.double(), dim=-1).float()
    return F.pad(ii, (1, 0, 1, 0))


def integral_images(img: torch.Tensor):
    """``(ii, stack([ii2, iic]))``: the SAT, and the SATs of the centred
    square and the centred image (stacked on a new leading dim)."""
    img = img.to(torch.float32)
    centred = img - CENTRE
    ii = integral_image(img)
    ii2 = integral_image(centred * centred)
    iic = integral_image(centred)
    return ii, torch.stack([ii2, iic])


def rect_sum(ii: torch.Tensor, ys, xs, h, w) -> torch.Tensor:
    """Sum of pixels in ``[ys, ys+h) x [xs, xs+w)``, ordering
    ``d - b - c + a``; index tensors broadcast over leading SAT dims."""
    y1 = ys + h
    x1 = xs + w
    return (ii[..., y1, x1] - ii[..., ys, x1] - ii[..., y1, xs]
            + ii[..., ys, xs])


def div_rn(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d``, correctly rounded on every device.  PyTorch's CUDA
    division by a Python (or CPU) scalar multiplies by the scalar's
    reciprocal, which rounds differently from the kernels' IEEE division;
    dividing by a 0-dim tensor on ``x``'s device takes the true division."""
    return x / torch.scalar_tensor(d, dtype=x.dtype, device=x.device)


def inv_sigma_of(var: torch.Tensor) -> torch.Tensor:
    """``1 / sqrt(max(var, 1))`` in float32, correctly rounded on every
    device.  PyTorch's float32 ``sqrt`` on the CPU is not always correctly
    rounded, so the root is taken in float64 and rounded once to float32,
    which gives the correctly rounded float32 root (the kernels' IEEE
    ``sqrtf``)."""
    root = torch.sqrt(torch.clamp(var, min=1.0).double()).float()
    return torch.reciprocal(root)


def window_inv_sigma(ii_pair, ys, xs, window: int) -> torch.Tensor:
    """1/sigma per window: ``var = s2/n - (s1/n)^2`` and
    ``1 / sqrt(max(var, 1))`` (paper Eq. 5, float-safe form).  ``ii_pair``
    is the ``(ii2, iic)`` pair of :func:`integral_images`."""
    n = float(window * window)
    ii2, iic = ii_pair[0], ii_pair[1]
    s2 = rect_sum(ii2, ys, xs, window, window)
    s1 = rect_sum(iic, ys, xs, window, window)
    mean = div_rn(s1, n)
    return inv_sigma_of(div_rn(s2, n) - mean * mean)


def integral_value(img: torch.Tensor) -> torch.Tensor:
    """The paper's 'integral value' (the RIT relation, Eq. 6): the sum of
    every pixel of the image, the SAT's bottom-right entry, as a 0-dim
    float32 tensor.  Accumulated in float64 and rounded once, so every
    device gives the same bits (exact for integer-valued images)."""
    return img.to(torch.float64).sum().to(torch.float32)
