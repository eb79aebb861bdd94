"""device_busy_ms_per_batch: the union of the device's operation
intervals in the traced slice, in ms, over the batches in it."""


def read(ctx):
    sl = ctx["slice"]
    n = len(sl["log"].batches)
    if not n or not sl["kernels"]:
        return None
    return sl["busy_s"] * 1e3 / n
