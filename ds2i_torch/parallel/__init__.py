from .build_pool import OrderedBuildPool


def __getattr__(name):
    # lazy: doc_sharded pulls in the engine/index stack, which itself
    # imports this package for OrderedBuildPool
    if name in ("DocShardedEngine", "shard_index_by_doc_range", "shard_collection_by_doc_range"):
        from . import doc_sharded

        return getattr(doc_sharded, name)
    raise AttributeError(name)
