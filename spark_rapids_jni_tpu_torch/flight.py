"""CLI entry: ``python -m spark_rapids_jni_tpu_torch.flight ls|show``.

Thin shim over :mod:`spark_rapids_jni_tpu_torch.runtime.flight` (kept
importable from both paths, the :mod:`.traceview` convention; the
implementation lives in runtime/ next to the recorder it reads)."""

from .runtime.flight import (  # noqa: F401  (re-exports)
    flight_dir,
    main,
    maybe_record,
)

if __name__ == "__main__":
    raise SystemExit(main())
