"""Shared tool helpers: index persistence with embedded type tag, stats."""

import numpy as np

from ..index import freeze, load, size_tree
from ..index.types import make_index_type
from ..queries.wand_data import WandData


def save_index(index, path):
    tree = index.tree()
    tree["index_type"] = index.index_type_name
    return freeze(tree, path)


def load_index(path, type_name=None):
    tree = load(path)
    name = tree.get("index_type", type_name)
    if type_name and name != type_name:
        raise ValueError(f"index file is '{name}', requested '{type_name}'")
    cls = make_index_type(name)
    return cls.from_tree(tree)


def save_wand_data(wdata, path):
    return freeze(wdata.tree(), path)


def load_wand_data(path):
    return WandData.from_tree(load(path))


def postings_stats(index, collection):
    """bits_per_doc / bits_per_freq (index_build_utils.hpp:74-91 equivalent).
    Block indexes interleave docs/freqs bytes, so they report a combined
    bits_per_posting instead."""
    postings = sum(index.list_length(i) for i in range(index.size()))
    if hasattr(index, "docs_sequences"):
        docs_bits = index.docs_sequences.bits_bv.nbits + index.docs_sequences.endpoints_bv.nbits
        freqs_bits = index.freqs_sequences.bits_bv.nbits + index.freqs_sequences.endpoints_bv.nbits
        return {
            "postings": postings,
            "bits_per_doc": docs_bits / postings,
            "bits_per_freq": freqs_bits / postings,
        }
    total_bits = len(index.lists) * 8 + index.endpoints_bv.nbits
    return {
        "postings": postings,
        "bits_per_posting_total": total_bits / postings,
    }
