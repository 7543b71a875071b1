"""The port's dry-run specs against the JAX package's, on the CPU (no devices, meta tensors).

For every config, at full width and at its smoke size: the serving
caches (``Model.abstract_caches`` and each module's
``abstract_kv_cache`` / ``abstract_ssm_state`` / ``abstract_rglru_state``),
their logical axes (``cache_specs``, ``kv_cache_specs``,
``ssm_state_specs``, ``rglru_state_specs``), the step inputs
(``input_specs``) and ``model_flops`` for each shape of ``SHAPES``,
AdamW's ``abstract_state`` / ``state_specs`` and the compression
state's ``abstract_state``, against the reference's, whose caches and
layers are stacked per pattern position (unstacked here, one cache per
layer, as the port keeps them); and ``ModelConfig.is_attention_free``.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro import optim as jax_optim  # noqa: E402
from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import make_model as jax_make_model  # noqa: E402
from repro.models import rglru as jax_rglru  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.optim import compression as jax_compression  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import ARCH_NAMES, SHAPES, get_config  # noqa: E402
from repro_torch.models import attention, make_model, rglru, ssm  # noqa: E402
from repro_torch.models.transformer import layer_kinds, pattern_of  # noqa: E402
from repro_torch.optim import compression  # noqa: E402
from repro_torch.parallel.mesh_rules import axes_leaves, is_axes  # noqa: E402
from repro_torch.tree import tree_leaves, tree_leaves_with_path  # noqa: E402
from test_torch_mesh_rules import reference_leaf  # noqa: E402

SIZES = ("full", "smoke")
BATCH, MAX_LEN = 3, 40


def configs(arch, size):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    return (cfg, jcfg) if size == "full" else (cfg.smoke(), jcfg.smoke())


def fields(c) -> dict:
    """A cache's (or a ``{"self", "cross"}`` pair's) leaves by name."""
    if isinstance(c, dict):
        return {(k, name): v for k, part in c.items() for name, v in fields(part).items()}
    names = [f.name for f in dataclasses.fields(c)] if dataclasses.is_dataclass(c) else c._fields
    return {(name,): getattr(c, name) for name in names}


def reference_layers(tree, cfg):
    """The reference's stacked cache tree as (layer's cache, stacked) per layer."""
    if cfg.family == "encdec":
        return [(tree, True)] * cfg.num_layers
    pat, repeats, rem = pattern_of(cfg)
    n = repeats * len(pat)
    return ([(tree["blocks"][i % len(pat)], True) for i in range(n)]
            + [(tree["remainder"][j], False) for j in range(len(rem))])


def dtype_name(d) -> str:
    return str(d).replace("torch.", "")


def assert_same_caches(got, want_tree, cfg):
    """Each layer's meta tensors against the reference's stand-ins, unstacked."""
    want = reference_layers(want_tree, cfg)
    assert len(got) == len(want)
    for i, (mine, (theirs, stacked)) in enumerate(zip(got, want)):
        a, b = fields(mine), fields(theirs)
        assert sorted(a) == sorted(b), i
        for name, t in a.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(b[name].shape)[int(stacked):], (i, name)
            assert dtype_name(t.dtype) == dtype_name(b[name].dtype), (i, name)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_abstract_caches_and_specs_match_reference(arch, size):
    cfg, jcfg = configs(arch, size)
    model, jmodel = make_model(cfg, device="cpu"), jax_make_model(jcfg)
    assert_same_caches(model.abstract_caches(BATCH, MAX_LEN),
                       jmodel.abstract_caches(BATCH, MAX_LEN), cfg)
    specs = model.cache_specs(BATCH, MAX_LEN)
    want = reference_layers(jmodel.cache_specs(BATCH, MAX_LEN), cfg)
    assert len(specs) == len(want)
    for mine, (theirs, stacked) in zip(specs, want):
        a, b = fields(mine), fields(theirs)
        assert sorted(a) == sorted(b)
        for name, axes in a.items():
            assert is_axes(axes) and ((None,) + axes if stacked else axes) == b[name], name


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_module_cache_specs_match_reference(arch, size):
    cfg, jcfg = configs(arch, size)
    kinds = set(layer_kinds(cfg)) if cfg.family != "encdec" else {"attn"}
    pairs = []
    if kinds & {"attn", "moe", "cross"}:
        window = cfg.window if cfg.family == "hybrid" else 0
        pairs += [(attention.abstract_kv_cache(cfg, BATCH, MAX_LEN, window),
                   jax_attention.abstract_kv_cache(jcfg, BATCH, MAX_LEN, window),
                   attention.kv_cache_specs(cfg), jax_attention.kv_cache_specs(jcfg))]
    if "ssd" in kinds:
        pairs += [(ssm.abstract_ssm_state(cfg, BATCH), jax_ssm.abstract_ssm_state(jcfg, BATCH),
                   ssm.ssm_state_specs(cfg), jax_ssm.ssm_state_specs(jcfg))]
    if "rglru" in kinds:
        pairs += [(rglru.abstract_rglru_state(cfg, BATCH),
                   jax_rglru.abstract_rglru_state(jcfg, BATCH),
                   rglru.rglru_state_specs(cfg), jax_rglru.rglru_state_specs(jcfg))]
    assert pairs
    for abstract, jabstract, specs, jspecs in pairs:
        a, b = fields(abstract), fields(jabstract)
        assert sorted(a) == sorted(b)
        for name, t in a.items():
            assert t.device.type == "meta" and tuple(t.shape) == tuple(b[name].shape), name
            assert dtype_name(t.dtype) == dtype_name(b[name].dtype), name
        assert fields(specs) == fields(jspecs)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_specs_and_model_flops_match_reference(arch, size):
    cfg, jcfg = configs(arch, size)
    model, jmodel = make_model(cfg, device="cpu"), jax_make_model(jcfg)
    for name, shape in SHAPES.items():
        got, want = model.input_specs(shape), jmodel.input_specs(JAX_SHAPES[name])
        assert sorted(got) == sorted(want), name
        if shape.kind == "decode":
            assert_same_caches(got["caches"], want["caches"], cfg)
            got = {k: v for k, v in got.items() if k != "caches"}
            want = {k: v for k, v in want.items() if k != "caches"}
        else:
            got, want = got["batch"], want["batch"]
        assert sorted(got) == sorted(want), name
        for key, t in got.items():
            assert t.device.type == "meta" and tuple(t.shape) == tuple(want[key].shape), key
            assert dtype_name(t.dtype) == dtype_name(want[key].dtype), key
        assert model.model_flops(shape) == jmodel.model_flops(JAX_SHAPES[name]), name


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_optimizer_states_mirror_reference(arch, size):
    cfg, jcfg = configs(arch, size)
    model, jmodel = make_model(cfg, device="cpu"), jax_make_model(jcfg)
    aparams, japarams = model.abstract_params(), jmodel.abstract_params()
    pspecs, jpspecs = model.param_specs(), jmodel.param_specs()
    for dtype, jdtype in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        opt = optim.AdamW(cfg=cfg, state_dtype=dtype)
        jopt = jax_optim.AdamW(state_dtype=jdtype)
        state, jstate = opt.abstract_state(aparams), jopt.abstract_state(japarams)
        assert state.step.device.type == "meta" and tuple(state.step.shape) == ()
        assert dtype_name(state.step.dtype) == dtype_name(jstate.step.dtype) == "int32"
        for moments, jmoments in ((state.mu, jstate.mu), (state.nu, jstate.nu)):
            leaves = list(tree_leaves_with_path(moments))
            assert [p for p, _ in leaves] == [p for p, _ in tree_leaves_with_path(aparams)]
            for path, t in leaves:
                want, stacked = reference_leaf(jmoments, path, cfg)
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(want.shape)[int(stacked):], path
                assert dtype_name(t.dtype) == dtype_name(want.dtype) == jdtype, path
    specs, jspecs = optim.AdamW.state_specs(pspecs), jax_optim.AdamW().state_specs(jpspecs)
    assert specs.step == jspecs.step == ()
    for moments, jmoments in ((specs.mu, jspecs.mu), (specs.nu, jspecs.nu)):
        for axes, (path, _) in zip(axes_leaves(moments), tree_leaves_with_path(aparams)):
            want, stacked = reference_leaf(jmoments, path, cfg)
            assert (("stack",) + axes if stacked else axes) == want, path
    residual = compression.abstract_state(aparams).residual
    jresidual = jax_compression.abstract_state(japarams).residual
    for path, t in tree_leaves_with_path(residual):
        want, stacked = reference_leaf(jresidual, path, cfg)
        assert t.device.type == "meta" and t.dtype == torch.float32
        assert tuple(t.shape) == tuple(want.shape)[int(stacked):], path
    assert len(tree_leaves(residual)) == len(tree_leaves(aparams))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_is_attention_free_matches_reference(arch):
    assert get_config(arch).is_attention_free == jax_get_config(arch).is_attention_free
    assert get_config(arch).smoke().is_attention_free == \
        jax_get_config(arch).smoke().is_attention_free
