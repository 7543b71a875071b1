"""The port's config API and mesh rules against the JAX package's, on the CPU.

``ParallelConfig``'s fields and defaults, ``SHAPES``, ``cell_status`` and
``sub_quadratic``; ``MeshRules.spec`` of every parameter leaf of every
config at full width (``Model.param_specs()`` and ``abstract_params()``,
which allocate nothing) on the meshes (2, 2), (16, 16) and (2, 16, 16)
under the default knobs and with each of ``fsdp``, ``tensor_parallel``,
``replicate_kv`` and ``sequence_parallel`` switched, against the
reference's on an ``AbstractMesh`` (no devices needed); ``local_slice``;
and ``init()``, which the axes must leave bitwise as it was.
"""

import dataclasses
import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import ParallelConfig as JaxParallelConfig  # noqa: E402
from repro.configs import cell_status as jax_cell_status  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import make_model as jax_make_model  # noqa: E402
from repro.parallel.mesh_rules import MeshRules as JaxMeshRules  # noqa: E402
from repro_torch.configs import (ARCH_NAMES, SHAPES, ParallelConfig, cell_status,  # noqa: E402
                                 get_config)
from repro_torch.models import make_model  # noqa: E402
from repro_torch.models.transformer import pattern_of  # noqa: E402
from repro_torch.parallel import mesh_rules  # noqa: E402
from repro_torch.parallel.mesh_rules import MeshRules, MeshShape, axes_leaves  # noqa: E402
from repro_torch.tree import tree_leaves, tree_leaves_with_path  # noqa: E402

MESHES = {(2, 2): ("data", "model"), (16, 16): ("data", "model"),
          (2, 16, 16): ("pod", "data", "model")}
VARIANTS = {"default": {}, "no_fsdp": {"fsdp": False}, "no_tp": {"tensor_parallel": False},
            "replicate_kv": {"replicate_kv": True}, "sp": {"sequence_parallel": True}}

# sha256 of init(seed 3)'s leaves (paths and bytes, in order) of each smoke()
# config, taken before the builders took logical axes
INIT_DIGESTS = {
    "tinyllama-1.1b": "54e49943f77f4d87ed0ec0ebac4d72b7",
    "mamba2-130m": "f90e153a99c1fa8e088dd620978c7c43",
    "qwen3-moe-30b-a3b": "c5fbe00def36b8c100118f139c85f764",
    "recurrentgemma-9b": "79e283ed3cf2df50b42c0263b094f5d8",
    "whisper-large-v3": "b418ce782522b05505fd11db4717bd6b",
    "llama-3.2-vision-90b": "bb3c78fb71f9f6b48d777d2452de18c3",
    "grok-1-314b": "c2764bbf0a51c35e0b6fce6b208764e7",
    "stablelm-12b": "54e49943f77f4d87ed0ec0ebac4d72b7",
    "qwen3-14b": "b2ff6b9ae87ab5bb49fb01e8c59aa86c",
    "llama3.2-3b": "4d6b79573260a8458fd5d913da5ebeff",
}


def test_config_api_matches_reference():
    fields = [(f.name, f.default) for f in dataclasses.fields(ParallelConfig)]
    assert fields == [(f.name, f.default) for f in dataclasses.fields(JaxParallelConfig)]
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in JAX_SHAPES.items()}
    for arch in ARCH_NAMES:
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        assert dataclasses.asdict(cfg.parallel) == dataclasses.asdict(jcfg.parallel), arch
        assert cfg.sub_quadratic == jcfg.sub_quadratic, arch
        for name in SHAPES:
            assert cell_status(cfg, SHAPES[name]) == jax_cell_status(jcfg, JAX_SHAPES[name])


def reference_leaf(tree, path, cfg):
    """(the reference's leaf for the port's leaf at ``path``, whether the
    reference stacks it on a leading layer dim)."""
    if cfg.family == "encdec" and path[0] in ("enc_blocks", "dec_blocks"):
        node, rest, stacked = tree[path[0]], path[2:], True
    elif path[0] == "layers":
        pat, repeats, _ = pattern_of(cfg)
        i = path[1]
        stacked = i < repeats * len(pat)
        node = tree["blocks"][i % len(pat)] if stacked else tree["remainder"][i - repeats * len(pat)]
        rest = path[2:]
    else:
        node, rest, stacked = tree, path, False
    for key in rest:
        node = node[key]
    return node, stacked


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("mesh_shape", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_spec_of_every_leaf_matches_reference(arch, mesh_shape, variant):
    names = MESHES[mesh_shape]
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    par = dataclasses.replace(cfg.parallel, **VARIANTS[variant])
    jpar = dataclasses.replace(jcfg.parallel, **VARIANTS[variant])
    rules = MeshRules(MeshShape(mesh_shape, names), par)
    jrules = JaxMeshRules(AbstractMesh(mesh_shape, names), jpar)
    model, jmodel = make_model(cfg, device="cpu"), jax_make_model(jcfg)
    jspecs, jshapes = jmodel.param_specs(), jmodel.abstract_params()
    specs, shapes = model.param_specs(), model.abstract_params()
    leaves = list(tree_leaves_with_path(shapes))
    assert len(axes_leaves(specs)) == len(leaves)
    sharded = 0
    for axes, (path, meta) in zip(axes_leaves(specs), leaves):
        assert meta.device.type == "meta"
        jaxes, stacked = reference_leaf(jspecs, path, cfg)
        jshape, _ = reference_leaf(jshapes, path, cfg)
        want = tuple(jrules.spec(jaxes, jshape.shape))
        got = rules.spec(axes, tuple(meta.shape))
        assert ((None,) + got if stacked else got) == want, (path, got, want)
        assert tuple(jshape.shape)[int(stacked):] == tuple(meta.shape), path
        sharded += any(e is not None for e in got)
    assert sharded > 0


def test_unknown_axis_raises():
    rules = MeshRules(MeshShape((2, 2), ("data", "model")), ParallelConfig())
    jrules = JaxMeshRules(AbstractMesh((2, 2), ("data", "model")), JaxParallelConfig())
    for r in (rules, jrules):
        with pytest.raises(KeyError, match="unknown logical axis"):
            r.spec(("embed", "nonsense"), (8, 8))


@pytest.mark.parametrize("arch", list(INIT_DIGESTS))
def test_init_is_unchanged_and_specs_mirror_it(arch):
    cfg = get_config(arch).smoke()
    model = make_model(cfg, device="cpu")
    params = model.init(3)
    h = hashlib.sha256()
    for path, leaf in tree_leaves_with_path(params):
        h.update(repr(path).encode())
        h.update(leaf.reshape(-1).contiguous().view(torch.uint8).numpy().tobytes())
    assert h.hexdigest()[:32] == INIT_DIGESTS[arch]
    specs, shapes = model.param_specs(), model.abstract_params()
    assert [p for p, _ in tree_leaves_with_path(shapes)] == [
        p for p, _ in tree_leaves_with_path(params)]
    for axes, meta, leaf in zip(axes_leaves(specs), tree_leaves(shapes), tree_leaves(params)):
        assert len(axes) == leaf.dim() and meta.shape == leaf.shape and meta.dtype == leaf.dtype


def test_local_slice_partitions_every_leaf():
    """The shards of every rank of a (pod 2, data 2, model 1) mesh cover
    each tensor exactly once; a dim over ("data", "pod") is data-major."""
    mesh = MeshShape((2, 2, 1), ("pod", "data", "model"))
    rules = MeshRules(mesh, ParallelConfig())
    assert rules.spec(("embed", "qheads"), (8, 4)) == (("data", "pod"), "model")
    coords = [dict(pod=p, data=d, model=0) for p in range(2) for d in range(2)]
    got = [rules.local_slice((("data", "pod"),), (8,), c)[0] for c in coords]
    assert got == [slice(0, 2), slice(4, 6), slice(2, 4), slice(6, 8)]
    assert rules.local_slice(("data", None), (8, 3), coords[3]) == (slice(4, 8), slice(None))
    cfg = get_config("tinyllama-1.1b").smoke()
    model = make_model(cfg, device="cpu")
    for axes, meta in zip(axes_leaves(model.param_specs()), tree_leaves(model.abstract_params())):
        spec = rules.spec(axes, tuple(meta.shape))
        count = np.zeros(tuple(meta.shape), np.int64)
        for c in coords:
            count[rules.local_slice(spec, tuple(meta.shape), c)] += 1
        names = [n for e in spec if e is not None for n in ((e,) if isinstance(e, str) else e)]
        assert (count == 4 // np.prod([rules.axis_sizes[n] for n in names])).all(), (axes, spec)
    assert rules.coordinate() == {"pod": 0, "data": 0, "model": 0}


def test_ambient_rules_and_hints():
    rules = MeshRules(MeshShape((1, 1), ("data", "model")), ParallelConfig())
    x = torch.ones(2, 3)
    assert mesh_rules.current_rules() is None
    with mesh_rules.use_rules(rules):
        assert mesh_rules.current_rules() is rules
        assert mesh_rules.shard_hint(x, "act_batch", "act_embed") is x
        with mesh_rules.hints_disabled():
            assert mesh_rules.shard_hint(x, "act_batch", "act_embed") is x
    assert mesh_rules.current_rules() is None
