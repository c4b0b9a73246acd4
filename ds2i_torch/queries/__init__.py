from .parsing import read_queries, remove_duplicate_terms, query_freqs
from .bm25 import BM25
from .topk import TopKQueue
from .wand_data import WandData
from .boolean import and_query, or_query
from .ranked import ranked_and_query, ranked_or_query
from .wand import wand_query
from .maxscore import maxscore_query

QUERY_OPS = {
    "and": lambda index, wdata, k: (lambda terms: and_query(index, terms)),
    "or": lambda index, wdata, k: (lambda terms: or_query(index, terms)),
    "and_freq": lambda index, wdata, k: (lambda terms: and_query(index, terms, with_freqs=True)),
    "or_freq": lambda index, wdata, k: (lambda terms: or_query(index, terms, with_freqs=True)),
    "ranked_and": lambda index, wdata, k: (lambda terms: ranked_and_query(index, wdata, terms, k)),
    "ranked_or": lambda index, wdata, k: (lambda terms: ranked_or_query(index, wdata, terms, k)),
    "wand": lambda index, wdata, k: (lambda terms: wand_query(index, wdata, terms, k)),
    "maxscore": lambda index, wdata, k: (lambda terms: maxscore_query(index, wdata, terms, k)),
}
