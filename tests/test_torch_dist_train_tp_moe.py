"""The port's moe family on a (2, 2) mesh against the JAX package's.

As ``test_torch_dist_train_tp.py`` (its helpers, tolerances and reference
subprocess), for qwen3-moe-30b-a3b's smoke config in ``local`` dispatch
(each data shard routes its own tokens; each model rank serves 2 of the 4
experts), in ``gspmd`` dispatch (the data group's global plan), with 3
experts (which do not split over the model axis: every rank serves every
expert over its half of ``expert_mlp``), and grok-1-314b's (``local``
with sequence parallelism and 2 microbatches, their gradients summed in
float32, and again in bfloat16 as its config has it, held on its losses
and ``grad_norm``).  The aux values'
mean over the data axes carries its gradient, and the loss's aux terms
are held with it.
"""

import pytest

torch = pytest.importorskip("torch")

from test_torch_dist_train_tp import (case_config, check_case, k4_heads, rank_main,  # noqa: E402
                                      reference, spawn)

NAMES = ("qwen3-moe-30b-a3b local", "qwen3-moe-30b-a3b gspmd", "qwen3-moe-30b-a3b 3 experts",
         "grok-1-314b", "grok-1-314b bf16 accumulation")


def _rank(rank: int, world: int, tmp: str) -> None:
    rank_main(rank, world, tmp, NAMES)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_train_tp_moe")
    ref = reference(tmp, NAMES)
    return ref, spawn(_rank, tmp)


@pytest.mark.parametrize("name", NAMES)
def test_sharded_moe_step_matches_reference(runs, name):
    ref, ranks = runs
    got = check_case(name, ref, ranks)
    cfg = case_config(name)
    assert got["k4_calls"] == [k4_heads(cfg)]
    w1 = got["blocks"][("layers", 0, "moe", "w1")]
    e, d, ff = w1[1]
    # expert-parallel where the experts split over the model axis, else the
    # expert hidden dim; and FSDP over the data axis either way
    assert w1[0] == ((e // 2, d // 2, ff) if e % 2 == 0 else (e, d // 2, ff // 2))
