"""torch_ops_per_batch: the torch ops one call of the cell's entry
dispatches on the host for one batch (the first), counted by a
``TorchDispatchMode`` after the window."""


def read(ctx):
    return ctx.get("ops_per_batch")
