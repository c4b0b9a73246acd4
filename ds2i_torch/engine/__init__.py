"""The port's serving engine (EF-family indexes in pair mode, the block
indexes block_optpfor, block_varint, block_interpolative, block_qmx and
block_mixed in split mode)."""

from .resident import ResidentEngine
from .state import ResidentState, resident_state_from_arrays

__all__ = ["ResidentEngine", "ResidentState", "resident_state_from_arrays"]
