"""Query parsing (queries.hpp:15-33, 136-150): whitespace-separated term ids,
one query per line; duplicates removed for boolean ops, multiplicities kept
for ranked ops."""


def read_queries(stream_or_path):
    if isinstance(stream_or_path, str):
        with open(stream_or_path) as f:
            return read_queries(f)
    out = []
    for line in stream_or_path:
        terms = [int(t) for t in line.split()]
        if line.strip() or terms:
            out.append(terms)
    return out


def remove_duplicate_terms(terms):
    return sorted(set(terms))


def query_freqs(terms):
    """[(term, multiplicity)] sorted by term id."""
    out = []
    for t in sorted(terms):
        if out and out[-1][0] == t:
            out[-1] = (t, out[-1][1] + 1)
        else:
            out.append((t, 1))
    return out
