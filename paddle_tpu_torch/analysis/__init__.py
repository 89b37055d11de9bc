"""Host-side checks of the PyTorch port (counterpart of a part of
paddle_tpu/analysis/): the runtime validator of ``# guarded-by:`` lock
annotations (``lock_check``) and the analysis mode it reads."""
from __future__ import annotations

import os

__all__ = ["mode"]


def mode() -> str:
    """Current analysis mode: 'off' | 'warn' | 'strict', from the
    ``PT_ANALYSIS`` environment variable (default 'off')."""
    return os.environ.get("PT_ANALYSIS", "off").lower()
