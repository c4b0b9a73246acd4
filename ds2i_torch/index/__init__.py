from .mapper import freeze, load, size_tree
from .bitvector_collection import BitvectorCollection
from .freq_index import FreqIndex
from .types import INDEX_TYPES, make_index_type
