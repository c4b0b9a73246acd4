from .binary_collection import (
    BinaryCollection,
    BinaryFreqCollection,
    read_sizes,
    write_binary_collection,
)
from .gen_collection import generate_collection
