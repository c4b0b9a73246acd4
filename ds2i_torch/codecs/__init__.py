from .vbyte import TightVariableByte
from .interpolative import InterpolativeBlock, BitWriter32, BitReader32
from .simple16 import simple16_encode, simple16_decode
from .optpfor import OptPForBlock
from .varint import VarintG8IUBlock
from .qmx import QMXBlock
from .mixed import MixedBlock, BLOCK_CODECS_BY_TYPE

BLOCK_CODECS = {
    "optpfor": OptPForBlock,
    "varint": VarintG8IUBlock,
    "interpolative": InterpolativeBlock,
    "qmx": QMXBlock,
    "mixed": MixedBlock,
}
