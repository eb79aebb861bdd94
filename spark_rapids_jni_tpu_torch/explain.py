"""CLI entry: ``python -m spark_rapids_jni_tpu_torch.explain [journal] [--port N]``.

Thin shim over :mod:`spark_rapids_jni_tpu_torch.runtime.explain` (kept
importable from both paths; the implementation lives in runtime/ next
to the plan cache it renders)."""

from .runtime.explain import (  # noqa: F401  (re-exports)
    fetch_plans,
    main,
    render_journal,
    render_live,
)

if __name__ == "__main__":
    raise SystemExit(main())
