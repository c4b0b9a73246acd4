from .bitvector import BitVector, BitVectorBuilder, BitReader
from .codes import (
    write_gamma,
    write_gamma_nonzero,
    read_gamma,
    read_gamma_nonzero,
    write_delta,
    read_delta,
    gamma_bitsize,
    delta_bitsize,
)
