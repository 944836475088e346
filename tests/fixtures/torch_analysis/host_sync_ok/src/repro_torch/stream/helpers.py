"""Outside the hot-path file set: host materialisation is fine here."""


def to_host(x):
    return x.cpu().numpy(), x.tolist(), x.item()
