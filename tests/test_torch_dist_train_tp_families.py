"""The hybrid, encdec and vlm families on a (2, 2) mesh against the JAX package's.

As ``test_torch_dist_train_tp.py`` (its helpers, tolerances and reference
subprocess), for recurrentgemma-9b's smoke config (its one kv head of 8
columns is cut by the rules' split of ``kvheads``: ``wk`` and ``wv`` are
gathered over the model axis and every rank reads that head; the RG-LRU
block is column-parallel over ``lru``), whisper-large-v3's (the encoder
states enter the decoder's cross-attention whole) and
llama-3.2-vision-90b's (sequence parallelism, 2 microbatches, its cross
gates opened to 0.5 on both sides).
"""

import pytest

torch = pytest.importorskip("torch")

from test_torch_dist_train_tp import (case_config, check_case, k4_heads, rank_main,  # noqa: E402
                                      reference, spawn)

NAMES = ("recurrentgemma-9b", "whisper-large-v3", "llama-3.2-vision-90b")


def _rank(rank: int, world: int, tmp: str) -> None:
    rank_main(rank, world, tmp, NAMES)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_train_tp_families")
    ref = reference(tmp, NAMES)
    return ref, spawn(_rank, tmp)


@pytest.mark.parametrize("name", NAMES)
def test_sharded_step_matches_reference(runs, name):
    ref, ranks = runs
    got = check_case(name, ref, ranks)
    cfg = case_config(name)
    assert got["k4_calls"] == [k4_heads(cfg)]
    if name == "recurrentgemma-9b":
        # the cut kv head: the block of wk is half a head, and the gathered
        # head is read by both ranks' query heads
        part, full, _, split = got["blocks"][("layers", 2, "attn", "wk")]
        assert split and full[1] == cfg.head_dim and part[1] == cfg.head_dim // 2
