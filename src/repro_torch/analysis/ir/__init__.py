"""IR-level analysis: run the port's entry points on the ``meta`` device
and check what they do (port of ``repro.analysis.ir``).

Importing this package imports torch and the port's engines; the AST half
of ``repro_torch.analysis`` does not, so the CLI imports this lazily behind
``--ir``.
"""
from repro_torch.analysis.ir.framework import (  # noqa: F401
    DEFAULT_BUDGETS_PATH,
    DEFAULT_WAIVERS_PATH,
    HEADROOM,
    IRContext,
    IRPass,
    IRRunResult,
    IRTarget,
    TRACE_PASS,
    all_ir_passes,
    load_waivers,
    register_ir_pass,
    run_ir,
)
from repro_torch.analysis.ir.liveness import (  # noqa: F401
    PeakReport,
    Traced,
    counted_run,
    peak_live_bytes,
    peak_report,
)
from repro_torch.analysis.ir.targets import (  # noqa: F401
    ALIASES,
    CANON,
    MESH_SHAPES,
    UNSUPPORTED_PAIRS,
    default_targets,
)
