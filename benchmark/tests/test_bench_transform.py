"""A configuration built by transformation of another's index (deploy.py's
optimal hybrid): tiny_mixed from tiny_block, on the CPU."""

import json
import os

import numpy as np
import pytest

import deploy
from conftest import TRANSFORM, make_root

MIXED_FILE = "benchmark/configs/tiny_mixed.json"


def _built(root):
    return os.path.join(root, "build", "benchmark", "tiny_mixed")


def test_transformed_index_is_block_mixed_with_several_codecs(tiny_root):
    from ds2i_torch.codecs.mixed import BLOCK_TYPES, INTERPOLATIVE
    from ds2i_torch.tools.common import load_index

    path, _, _ = deploy.ensure(tiny_root, MIXED_FILE, "cpu", lambda msg: None)
    index = load_index(os.path.join(path, "index.bin"))
    assert index.index_type_name == "block_mixed"
    # each full block's docs and freqs streams open with their codec's byte
    full = [int(s[0]) for li in range(index.size()) for b in index.get_blocks(li)
            if b.size == index.codec.block_size for s in (b.docs_bytes, b.freqs_bytes)]
    by_type = np.bincount(full, minlength=BLOCK_TYPES)
    assert (by_type > 0).sum() >= 2, by_type
    with open(os.path.join(path, "built.json")) as f:
        rec = json.load(f)
    recorded = np.zeros(BLOCK_TYPES, np.int64)
    for key, n in rec["streams"].items():
        recorded[int(key.strip("()").split(",")[0])] += n
    recorded[INTERPOLATIVE] -= rec["partial_streams"]
    assert recorded.tolist() == by_type.tolist()
    assert rec["budget_bytes"] == round(TRANSFORM["budget_share"] * rec["source_bytes"])
    for stage in ("profile_s", "lambdas_s", "greedy_s", "rebuild_s", "engine_s", "state_s"):
        assert rec[stage] > 0, stage
    # the source's collection and wand data are linked, not written again
    for name in ("coll.docs", "coll.freqs", "coll.sizes", "coll.lens.npy", "wand.bin"):
        assert os.path.islink(os.path.join(path, name)), name
        assert os.path.samefile(os.path.join(path, name),
                                os.path.join(path, "..", "tiny_block", name))


def test_two_cold_set_ups_give_the_same_index(tiny_root, tmp_path):
    deploy.ensure(tiny_root, MIXED_FILE, "cpu", lambda msg: None)
    root = make_root(tmp_path)
    _, cold, took = deploy.ensure(root, MIXED_FILE, "cpu", lambda msg: None)
    assert cold is not None and took > 0
    for name in ("index.bin", "list_bytes.npy"):
        with open(os.path.join(_built(tiny_root), name), "rb") as a, \
                open(os.path.join(_built(root), name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("key, value, says", [
    *[(k, None, k) for k in deploy.COLLECTION_KEYS],
    ("method", "greedy", "method"),
    ("budget_share", 0, "budget_share"),
])
def test_a_bad_transform_exits_naming_it(tmp_path, key, value, says):
    root = make_root(tmp_path)
    with open(os.path.join(root, MIXED_FILE)) as f:
        cfg = json.load(f)
    if key in cfg["transform"]:
        cfg["transform"][key] = value
    else:
        cfg[key] = not cfg[key] if isinstance(cfg[key], bool) else cfg[key] + 1
    with open(os.path.join(root, MIXED_FILE), "w") as f:
        json.dump(cfg, f)
    with pytest.raises(SystemExit, match=rf"tiny_mixed\.json: .*\b{says}\b"):
        deploy.ensure(root, MIXED_FILE, "cpu", lambda msg: None)
    # it exits before anything is built, the source included
    assert not os.path.exists(os.path.join(root, "build"))
