"""Rule set registration: importing this package registers every rule
of the port's analyzer into ``analysis.core.RULES``."""

from . import capture_safety, dispatch_purity, dtype_discipline  # noqa: F401
