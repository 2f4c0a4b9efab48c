"""LoRA's registry of grouped stacks: parameter layouts with TWO leading
stack dims (JAX ``lora/model.py`` ``register_grouped_stack`` :97). It holds
no model code, so a model module registers its layout at import without
importing :mod:`.model` (which imports the models).

Each entry: a path marker (a substring of the '/'-joined JAX path) -> the
regex of the plain 2-D kernel names that layout lifts to rank 4, the only
rank-4 shapes a two-stack split may interpret.
"""

from __future__ import annotations

import re
from typing import Dict

_GROUPED_STACK_LAYOUTS: Dict[str, "re.Pattern[str]"] = {}


def register_grouped_stack(path_marker: str, kernel_patterns) -> None:
    """Declare a parameter layout carrying two leading stack dims:
    ``path_marker`` is a substring of the '/'-joined path identifying it,
    ``kernel_patterns`` the regexes naming the 2-D kernels it stacks (any
    other rank-4 leaf under the marker is refused as ambiguous)."""
    _GROUPED_STACK_LAYOUTS[path_marker] = re.compile(
        "|".join(f"(?:{p})" for p in kernel_patterns)
    )


def _grouped_kernel_re(path: str):
    for marker, kernel_re in _GROUPED_STACK_LAYOUTS.items():
        if marker in path:
            return kernel_re
    return None
