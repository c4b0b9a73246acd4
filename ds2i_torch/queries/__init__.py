from .parsing import read_queries, remove_duplicate_terms, query_freqs
from .bm25 import BM25
from .wand_data import WandData
from .boolean import and_query, or_query
from .ranked import ranked_and_query, ranked_or_query
