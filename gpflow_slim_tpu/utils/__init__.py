from .checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from .logging import MetricsLogger
from .misc import (
    check_determinism,
    debug_nans,
    enable_compile_cache,
    named_scope,
    print_summary,
    require_gpu,
)

__all__ = [
    "save_checkpoint", "load_checkpoint", "latest_checkpoint",
    "MetricsLogger", "named_scope", "debug_nans", "check_determinism",
    "print_summary", "enable_compile_cache", "require_gpu",
]
