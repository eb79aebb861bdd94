"""The port's sprtcheck: the analyzer rules built on a taint model,
rewritten for torch code.

The JAX package's analyzer (``python -m spark_rapids_jni_tpu.analysis``)
already runs its generic rules over the port (``guarded-by``,
``acquires=``, ``plan-key-fold``, ``barrier-budget``, the ABI contract).
Its sync and dtype rules taint ``jnp``/``lax`` values and see nothing in
torch code; this package carries their torch counterparts
(``docs/PORT_SPRTCHECK.md`` maps every JAX rule):

    python -m spark_rapids_jni_tpu_torch.analysis            # the port
    python -m spark_rapids_jni_tpu_torch.analysis ops/x.py --json
    python -m spark_rapids_jni_tpu_torch.analysis --sarif          # CI annotations
    python -m spark_rapids_jni_tpu_torch.analysis --include-tests  # + tests/test_torch_*.py
    # sprtcheck: disable=<rule> — <why>                       # inline opt-out
"""

from .core import (  # noqa: F401
    RULES,
    Finding,
    analyze,
    default_root,
    render_json,
    render_sarif,
    render_text,
)

from . import rules as _rules  # noqa: F401  (registers the rule set)
