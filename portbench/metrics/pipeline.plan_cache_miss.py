"""pipeline.plan_cache_miss: the Pipeline's plan-cache misses counted over
the measured window (``runtime/metrics`` counter
``pipeline.plan_cache_miss``, read before and after it). Every batch shape
is built in set-up, so a miss in the window is a rebuild stall."""


def read(ctx):
    return ctx["counters"].get("pipeline.plan_cache_miss")
