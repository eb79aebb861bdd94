"""decimal128_roofline: the least time the traced slice's decimal128
launches need at the card's HBM bandwidth, over their device time.

Bytes of a launch over n rows, each input byte read once and each output
byte written once: two DECIMAL128 operands of 16 bytes a row in, the
16-byte product and the 1-byte overflow flag out (the chains give the
kernel no validity masks). The rows each launch is given come from the
configuration's side (``decimal128_launches``), batch by batch over the
slice's batches. Nothing is read where the configuration cannot say, or
where the trace's decimal128 launches are not the ones expected."""

ROW_BYTES = 16 + 16 + 16 + 1
NAME = "decimal128"


def read(ctx):
    sl, query = ctx["slice"], ctx["query"]
    launches = []
    for b in sl["log"].batches:
        rows = query.decimal128_launches(ctx["traffic"]["entry"], b["index"])
        if rows is None:
            return None
        launches += rows
    spans = [(e - s) / 1e6 for s, e, name in sl["kernels"] if NAME in name]
    if not spans or len(spans) != len(launches):
        return None
    least_s = sum(launches) * ROW_BYTES / ctx["peaks"]["hbm_bytes_per_s"]
    return 100.0 * least_s / sum(spans)
