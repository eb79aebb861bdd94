"""CLI entry: ``python -m spark_rapids_jni_tpu_torch.traceview <journal>``.

Thin shim over :mod:`spark_rapids_jni_tpu_torch.runtime.traceview` (kept
importable from both paths; the implementation lives in runtime/ next
to the span layer it renders)."""

from .runtime.traceview import (  # noqa: F401  (re-exports)
    check_trace,
    convert,
    load_journal,
    main,
    render_stats,
    span_stats,
    to_chrome_trace,
)

if __name__ == "__main__":
    raise SystemExit(main())
