"""device_idle_share: the share of the traced slice's host-clock length in
which no operation ran on the device, in %."""


def read(ctx):
    sl = ctx["slice"]
    if not sl["kernels"] or sl["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - sl["busy_s"] / sl["window_s"])
