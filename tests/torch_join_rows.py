"""Seeded query rows for the join and pack (K3) tests, in numpy alone
(the card's machine has no jax): buckets of rows laid as the engine's
plan lays them, and their JoinLayouts. Used by tests/test_torch_join.py
(against the JAX engine on the CPU) and tests/test_torch_cuda.py (the
kernel against join_part_torch on the card)."""

import numpy as np

from ds2i_torch.ops.join import CHUNK, JoinLayout

F32 = np.float32


def bucket_layout(bdir, qwtab, tgt, row_ents, k, ops, tmax, chunk=CHUNK):
    """A JoinLayout of the seeded bucket's real rows (its pack drops the
    two pad rows)."""
    n = len(row_ents)
    ent = np.asarray([e for es in row_ents for e in es], np.int32)
    nent = np.asarray([len(es) for es in row_ents], np.int64)
    bucket = {"dir": bdir, "qwtab": qwtab, "tgt": tgt}
    return JoinLayout(ent, np.cumsum(nent) - nent, nent, tgt[:n], qwtab[:n], [bucket],
                      np.arange(n, dtype=np.int32), k, ops, tmax, chunk=chunk)


def relaid(lay, chunk):
    """The part's JoinLayout with CTA items of at most `chunk` driving
    entries."""
    return JoinLayout(lay.ent, lay.rows[:, 0], lay.rows[:, 1], lay.rows[:, 2], lay.qw,
                      lay.buckets, lay.pack_idx, lay.k, lay.ops, lay.tmax, chunk=chunk)


def bucket_of(rows, tmax, num_docs, rng, equal=False):
    """A bucket of the given rows plus two all-sentinel pad rows, laid as
    seeded_bucket lays its own: rows[r][s] is slot s's list of blocks,
    each an ascending array of at most 32 docids (pads fill the rest of
    the block); an empty list is a slot without an entry. equal: every
    weight and query weight 0.5."""
    docs_b, w_b, row_ents = [], [], []
    n = len(rows)
    qwtab = np.zeros((n + 2, tmax), F32)
    tgt = np.zeros(n + 2, np.int32)
    for r, slots in enumerate(rows):
        tgt[r] = len(slots)
        ents = []
        for s, blocks in enumerate(slots):
            qwtab[r, s] = F32(0.5) if equal else F32(rng.uniform(0.2, 3.0))
            for d in blocks:
                blk = np.full(32, num_docs, np.int32)
                blk[:len(d)] = d
                wv = np.where(blk < num_docs, F32(0.5) if equal
                              else rng.uniform(0.05, 1.0, 32).astype(F32), F32(0))
                ents.append((len(docs_b) << 5) | s)
                docs_b.append(blk)
                w_b.append(wv.astype(F32))
        row_ents.append(ents)
    sent = len(docs_b)
    docs_b.append(np.full(32, num_docs, np.int32))
    w_b.append(np.zeros(32, F32))
    L = 128
    while L < 32 * max(len(e) for e in row_ents):
        L *= 2
    bdir = np.full((n + 2, L // 32), sent << 5, np.int32)
    for r, ents in enumerate(row_ents):
        bdir[r, :len(ents)] = ents
    return np.stack(docs_b), np.stack(w_b), bdir, qwtab, tgt, row_ents


def special_rows(kind, rng):
    """(rows for bucket_of, num_docs, equal) of one kind of row the
    kernel treats apart. Each slot draws its docids from a shared pool,
    so the slots of a row overlap and AND results exist."""
    num_docs = 5000 if kind == "long" else 700
    pool = np.sort(rng.choice(num_docs - 100, size=min(num_docs - 100, 3000), replace=False))

    def slot(size, mixed=False):
        d = np.sort(rng.choice(pool, size=min(size, len(pool)), replace=False))
        blocks, i = [], 0
        while i < len(d):  # mixed: blocks of 1-32 docids, pads inside the slot's run
            f = int(rng.randint(1, 33)) if mixed else 32
            blocks.append(d[i:i + f])
            i += f
        return blocks

    def size():
        return int(rng.randint(1, 300))

    if kind == "single":  # tgt 1: every real posting is a candidate
        rows = [[slot(size())] for _ in range(6)]
    elif kind == "top_shortest":  # the shortest slot is slot tgt-1
        rows = []
        for _ in range(6):
            nt = int(rng.randint(2, 5))
            rows.append([slot(int(rng.randint(200, 500))) for _ in range(nt - 1)] +
                        [slot(int(rng.randint(1, 60)))])
    elif kind == "empty_slot":  # a pruned row: slot 1 has no entry
        rows = [[slot(size()), [], slot(size())] for _ in range(4)]
        rows += [[slot(size()) for _ in range(3)] for _ in range(2)]
    elif kind == "mid_pads":  # opt's pads inside a slot's run
        rows = [[slot(size(), mixed=True) for _ in range(int(rng.randint(1, 5)))]
                for _ in range(5)]
        rows.append([slot(size(), mixed=True), slot(20)])
    elif kind == "ties":  # equal weights: the sums of a row tie
        rows = [[slot(size()) for _ in range(int(rng.randint(1, 5)))] for _ in range(6)]
    elif kind == "wide":  # 17-32 slots (tmax 32)
        rows = [[slot(int(rng.randint(1, 60)))] +
                [slot(int(rng.randint(20, 100))) for _ in range(int(rng.randint(16, 32)))]
                for _ in range(3)]
    else:  # long: rows of more driving entries than a CTA item takes
        rows = [[slot(1300), slot(1200)], [slot(1400), slot(1250), slot(1100)],
                [slot(40)]]
    return rows, num_docs, kind == "ties"


KINDS = ["single", "top_shortest", "empty_slot", "mid_pads", "ties", "wide", "long"]
