"""The port's serving engine (EF-family indexes in pair mode,
block_optpfor and block_interpolative in split mode)."""

from .resident import ResidentEngine
from .state import ResidentState, resident_state_from_arrays

__all__ = ["ResidentEngine", "ResidentState", "resident_state_from_arrays"]
