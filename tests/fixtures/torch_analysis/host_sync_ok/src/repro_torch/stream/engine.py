"""Clean HOST_SYNC twin: each sync names its endpoint of the transfer
contract with the port's marker."""


def polite_step(out):
    # repro_torch: ignore[HOST_SYNC] contract sync: the step's scalar verdict
    flags = out.flags.tolist()
    slots = out.slots.cpu().numpy()  # repro_torch: ignore[HOST_SYNC] slot decode
    return flags, slots
