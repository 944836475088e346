"""Clean twin: the root branches only on static projections."""


def integral_image(img, scale=None):
    if img.device.type == "cpu" and not img.is_cuda:
        img = img * 1
    if img.ndim == 2 and img.dim() == 2 and len(img) > 0:
        img = img[None]
    if img.size(0) > 1 or img.numel() == 0 or img.stride(-1) != 1:
        img = img.contiguous()
    if scale is None or isinstance(img, tuple):
        scale = 1.0
    return img * scale if img.shape[-1] > 1 else img


def integral_image_ref(img):
    return img
