"""The dry-run tooling (slice F3b): one rank's step on meta tensors over
shape-only groups, priced (``launch/dryrun.py``, ``launch/op_analysis.py``,
``launch/mesh.py``, ``launch/perf.py``, ``parallel/collectives.ShapeGroup``).

* The collective bytes of phases 9a, 10a and 10b of ``chip_smoke.py``,
  counted on four gloo ranks on the card (``PERF.md`` §5), to the byte, at
  full width on a (2, 2) mesh shape.  (``test_torch_dist_serve_tp.py``
  holds the shape-only groups to the real groups of four gloo ranks for
  every family at smoke size.)
* Per-rank parameter, moment, batch and cache bytes against the
  reference's ``memory_analysis().argument_size_in_bytes``, and dot FLOPs
  against its ``analyze_hlo``, for ``tests/test_dryrun_small.py``'s smoke
  configs on Auto (1, 1) and (2, 2) meshes: one reference subprocess with
  4 forced host devices, shared by the module.
* The microbatch shortcut against the full trace; the skips against the
  reference's ``cell_status``; production cells on the 16×16 mesh,
  including cut query heads; K4's and K5's meta routes.
"""

import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import (ARCH_NAMES, SHAPES, InputShape, cell_status,  # noqa: E402
                                 get_config)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.dryrun import STAND_INS, dry_run, run_cell  # noqa: E402
from repro_torch.launch.mesh import H100_SXM, make_production_mesh, make_test_mesh  # noqa: E402
from repro_torch.launch.op_analysis import analyze_step  # noqa: E402
from repro_torch.parallel.collectives import Group, ShapeGroup  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
MESH = make_test_mesh((2, 2), ("data", "model"))
ONE = make_test_mesh((1, 1), ("data", "model"))

# PERF.md §5: bytes a rank handed to (the model group, the data group) on
# four gloo ranks of the H100 (PR 20 runs 2-5, phase 9; PR 21 runs 1-3, phase 10)
CARD_BYTES = {
    "9a train step": (1_879_097_344, 2_717_583_372),
    "10a prefill": (377_487_360, 1_034_604_544),
    "10a decode step": (737_280, 1_034_604_544),
    "10b prefill": (202_715_136, 90_134_016),
    "10b decode step": (124_225_536, 90_134_016),
}


def card_case(name):
    """The config and step of a phase of chip_smoke.py: 9a is tinyllama-1.1b
    in bf16 at 4 x 2048, 1 microbatch (run_training's loss_chunk of 0);
    10a / 10b tinyllama-1.1b / mamba2-130m in float32, a 512-token prompt
    of 4 rows into caches of 1024, then decode steps against them."""
    if name.startswith("9a"):
        return get_config("tinyllama-1.1b"), InputShape("t", 2048, 4, "train"), {}
    arch = "tinyllama-1.1b" if name.startswith("10a") else "mamba2-130m"
    cfg = get_config(arch).replace(dtype="float32", param_dtype="float32")
    if "prefill" in name:
        return cfg, InputShape("p", 1024, 4, "prefill"), {"prompt": 512}
    return cfg, InputShape("d", 1024, 4, "decode"), {}


@pytest.mark.parametrize("name", list(CARD_BYTES))
def test_collective_bytes_equal_the_card_s(name):
    cfg, shape, kw = card_case(name)
    rec = dry_run(cfg, shape, MESH, loss_chunk=0, **kw)
    got = rec["collective_bytes_by_group"]
    assert (got["model"], got["data"]) == CARD_BYTES[name]


# ---------------------------------------------------------------------------
# the reference's memory analysis and HLO dot FLOPs (one subprocess)
# ---------------------------------------------------------------------------
SMOKE = (("tinyllama-1.1b", "train"), ("mamba2-130m", "train"),
         ("qwen3-moe-30b-a3b", "train"), ("recurrentgemma-9b", "decode"))
SMOKE_SHAPES = {"train": InputShape("t", 32, 4, "train"),
                "decode": InputShape("d", 64, 4, "decode")}
SSD_CALL = (4, 32, 4, 8, 16, 8)      # mamba2's smoke scan: B, S, H, P, N, chunk

REFERENCE = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, %r)
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType, Mesh
    from repro.configs import get_config
    from repro.configs.base import InputShape
    from repro.launch.hlo_analysis import analyze_hlo
    from repro.launch.steps import make_decode_step, make_train_step
    from repro.models import make_model
    from repro.models.ssm import _ssd_chunked
    from repro.optim import AdamW
    from repro.parallel.mesh_rules import MeshRules

    out = {}
    for shape in ((1, 1), (2, 2)):
        devices = np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
        mesh = Mesh(devices, ("data", "model"), axis_types=(AxisType.Auto,) * 2)
        for arch, kind in %r:
            cfg = get_config(arch).smoke()
            model = make_model(cfg)
            rules = MeshRules(mesh, cfg.parallel)
            with mesh:
                if kind == "train":
                    s = InputShape("t", 32, 4, "train")
                    opt = AdamW()
                    compiled = make_train_step(model, opt, rules, s, loss_chunk=0).jit().lower(
                        model.abstract_params(), opt.abstract_state(model.abstract_params()),
                        model.input_specs(s)["batch"]).compile()
                else:
                    s = InputShape("d", 64, 4, "decode")
                    spec = model.input_specs(s)
                    compiled = make_decode_step(model, rules, s).jit().lower(
                        model.abstract_params(), spec["tokens"], spec["positions"],
                        spec["caches"]).compile()
            out[f"{arch} {shape}"] = dict(
                argument_bytes=int(compiled.memory_analysis().argument_size_in_bytes),
                dot_flops=analyze_hlo(compiled.as_text()).dot_flops)
    # the SSD scan alone, forward and backward (mamba2's smoke call)
    b, s, h, p, n, q = %r
    S = jax.ShapeDtypeStruct
    grad = jax.jit(jax.grad(lambda *a: jnp.sum(_ssd_chunked(*a, q)[0]), argnums=(0, 1, 2, 3)))
    out["ssd fwd+bwd"] = analyze_hlo(grad.lower(
        S((b, s, h, p), jnp.float32), S((b, s, h), jnp.float32), S((b, s, n), jnp.float32),
        S((b, s, n), jnp.float32)).compile().as_text()).dot_flops
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
""") % (str(SRC), SMOKE, SSD_CALL)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("dryrun_ref") / "ref.json"
    run = subprocess.run([sys.executable, "-c", REFERENCE, str(path)], capture_output=True,
                         text=True, timeout=600, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(path.read_text())


def smoke_run(arch, kind, mesh, **kw):
    return dry_run(get_config(arch).smoke(), SMOKE_SHAPES[kind], mesh, loss_chunk=0, **kw)


@pytest.mark.parametrize("arch,kind", SMOKE)
@pytest.mark.parametrize("mesh", [ONE, MESH], ids=["1x1", "2x2"])
def test_argument_bytes_equal_the_reference_s(reference, arch, kind, mesh):
    """Parameters + AdamW moments (and step) + the rank's batch rows (a
    decode step's tokens, positions and caches) equal the reference's
    argument bytes.  One deliberate difference (ROADMAP.md queue 3): where
    the split cuts recurrentgemma's one kv head, a rank's KV cache holds
    that head whole (the reference's ``act_kv`` cuts it in two), so its
    cache carries, per attention layer, k and v of its rows × window ×
    (kv columns − kv columns / model size) more in float32."""
    cfg = get_config(arch).smoke()
    mem = smoke_run(arch, kind, mesh)["memory"]
    want = reference[f"{arch} {tuple(mesh.shape)}"]["argument_bytes"]
    extra = 0
    if kind == "decode" and mesh.shape[1] > 1 and cfg.num_kv_heads % mesh.shape[1]:
        rows = SMOKE_SHAPES[kind].global_batch // mesh.shape[0]
        cols = cfg.num_kv_heads * cfg.head_dim
        extra = cfg.attn_layer_count() * 2 * rows * cfg.window * (cols - cols // mesh.shape[1]) * 4
        assert extra > 0
    assert mem["argument_bytes"] == want + extra
    assert mem["argument_bytes"] == sum(v for k, v in mem.items() if k in (
        "param_bytes", "opt_state_bytes", "batch_bytes", "cache_bytes"))


def _plain_call_dots(fn, *shapes, **kw) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*(torch.empty(s, device="meta") for s in shapes), **kw)
    return counter.get_total_flops()


def _plain_grad_dots(fn, *shapes) -> float:
    """Dot FLOPs of ``fn`` on meta leaves that require grad, forward and
    autograd's backward of the sum of its output."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.enable_grad():
        leaves = [torch.empty(s, device="meta", requires_grad=True) for s in shapes]
        with FlopCounterMode(display=False) as counter:
            fn(*leaves).sum().backward()
    return counter.get_total_flops()


@pytest.mark.parametrize("arch,kind", SMOKE)
def test_dot_flops_beside_the_reference_s(reference, arch, kind):
    """``OpReport.dot_flops`` (1, 1) against ``analyze_hlo``'s, each
    difference derived:

    * remat replays: both sides replay each checkpointed unit's forward in
      the backward, so the replay adds the same dots to both;
    * the reference's chunked XLA attention: it chunks only past 1024
      positions (``q_chunk``), so at 32 positions it forms the full S × S
      scores in the forward, its replay and its backward, as the port's
      plain version does;
    * K4's causal halving: the port prices each K4 forward (the forward and
      its replay) by ``kernel_flops``, which halves the causal S × S
      product, and its backward by its kernels' own ``backward_flops``,
      f × ``kernel_flops`` (S formed four times and dP three times across
      its passes, with dV, dK and dQ: f = 5, f32 past D 64 S five times:
      5.5; in bf16 P and dS enter their products as two operands each, f =
      6.5; halved too); the plain path
      forms the full products in the forward and its replay (2 full
      forwards) and autograd's backward of its two einsums (four products:
      2 full forwards, counted here op by op).  So the kernel path's dots
      are attention layers × (2 · ½ + f · ½ − 2 − 2) full forwards from the
      plain path's;
    * K5: each forward and replay is priced by ``kernel_flops`` (K), the
      least operations of the scan, and each backward by its kernels'
      ``backward_flops`` (Kb), where the plain chunked scan's dots are P
      forward and PF forward and backward (counted here op by op): the
      kernel path differs from the plain one by layers × (2K + Kb − P −
      PF);
    * mamba2's plain path against the reference: torch's autograd of the
      chunked scan's three-operand einsums contracts otherwise than XLA's
      (the scan alone, forward and backward, each side's own count), and
      XLA turns the depthwise conv's weight gradient (a multiply and a sum
      over rows and positions) into a dot of 2 · B · S · C · W per layer,
      which torch leaves elementwise.
    """
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_plain
    from repro_torch.kernels.flash_attention.ops import backward_flops as k4_bwd_flops
    from repro_torch.kernels.flash_attention.ops import kernel_flops as k4_flops
    from repro_torch.kernels.ssd_scan.ops import backward_flops as k5_bwd_flops
    from repro_torch.kernels.ssd_scan.ops import kernel_flops as k5_flops
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked

    cfg = get_config(arch).smoke()
    want = reference[f"{arch} (1, 1)"]["dot_flops"]
    rec, plain = smoke_run(arch, kind, ONE), smoke_run(arch, kind, ONE, plain=True)
    got, got_plain = rec["ops"]["dot_flops"], plain["ops"]["dot_flops"]
    kinds = {k: v["calls"] for k, v in rec["ops"]["kernels"].items()}
    shape = SMOKE_SHAPES[kind]
    b, s = shape.global_batch, shape.seq_len
    if kind == "decode":
        assert kinds == {} and got == got_plain == want
        return
    if cfg.family == "ssm":
        B, S, H, P, N, Q = SSD_CALL
        assert (B, S, H, P, N, Q) == (b, s, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                                      cfg.ssm_chunk)
        assert kinds == {"ssd_scan": 2 * cfg.num_layers, "ssd_scan_backward": cfg.num_layers}
        shapes = ((B, S, H, P), (B, S, H), (B, S, N), (B, S, N))
        p_dots = _plain_call_dots(lambda *a: ssd_chunked(*a, Q), *shapes)
        pf_dots = _plain_grad_dots(lambda *a: ssd_chunked(*a, Q)[0], *shapes)
        assert got - got_plain == cfg.num_layers * (
            2 * k5_flops(B, S, H, P, N) + k5_bwd_flops(B, S, H, P, N) - p_dots - pf_dots)
        scan_delta = pf_dots - reference["ssd fwd+bwd"]
        conv = 2 * b * s * (cfg.ssm_d_inner + 2 * cfg.ssm_state) * cfg.conv_width
        assert got_plain - want == cfg.num_layers * (scan_delta - conv)
        assert scan_delta > 0
        return
    attn = cfg.attn_layer_count()
    assert kinds == {"flash_attention": 2 * attn, "flash_attention_backward": attn}
    h, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    full = 4.0 * b * h * s * s * d
    assert k4_flops(b, s, s, h, d) == full / 2
    f = 6.5 if cfg.dtype == "bfloat16" else 5.0 if cfg.head_dim <= 64 else 5.5
    assert k4_bwd_flops(b, s, s, h, d, bf16=cfg.dtype == "bfloat16") == f * full / 2
    shapes = ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d))
    assert _plain_call_dots(flash_attention_plain, *shapes) == full
    assert _plain_grad_dots(flash_attention_plain, *shapes) == full + 2 * full
    assert got - got_plain == attn * (2 * full / 2 + f * full / 2 - 2 * full - 2 * full)
    assert got_plain == want


# ---------------------------------------------------------------------------
# the shortcut, the skips, production cells, stand-ins
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mb", [2, 4])
def test_microbatch_shortcut_equals_the_full_trace(mb):
    """Tracing the first microbatch once and the second for the rest counts
    what tracing every microbatch counts: FLOPs, bytes, collectives by
    group and kind, kernel charges."""
    cfg = get_config("tinyllama-1.1b").smoke()
    shape = InputShape("t", 32, 8, "train")
    fast = dry_run(cfg, shape, MESH, microbatches=mb)
    full = dry_run(cfg, shape, MESH, microbatches=mb, shortcut=False)
    assert fast["microbatches"] == full["microbatches"] == mb
    for key in ("dot_flops", "hbm_bytes", "collective_bytes", "collective_by_group",
                "collective_by_kind", "collective_count", "kernels", "ops"):
        assert fast["ops"][key] == full["ops"][key], key
    one = dry_run(cfg, shape, MESH, microbatches=1)
    assert full["ops"]["kernels"]["flash_attention"]["calls"] == \
        mb * one["ops"]["kernels"]["flash_attention"]["calls"]


def test_skips_are_the_reference_s(tmp_path):
    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import cell_status as ref_status
    from repro.configs import get_config as ref_config

    assert list(SHAPES) == list(REF_SHAPES)
    skipped = 0
    for arch in ARCH_NAMES:
        for name, shape in SHAPES.items():
            assert cell_status(get_config(arch), shape) == ref_status(ref_config(arch),
                                                                      REF_SHAPES[name])
            if not cell_status(get_config(arch), shape)[0]:
                skipped += 1
                rec = run_cell(arch, name, False, tmp_path)
                assert rec["status"] == "skip" and "sub-quadratic" in rec["reason"]
                assert json.loads((tmp_path / f"{arch}__{name}__pod16x16.json").read_text()) == rec
    assert skipped == 8


@pytest.mark.parametrize("arch,shape", [("tinyllama-1.1b", "train_4k"),
                                        ("llama3.2-3b", "prefill_32k"),
                                        ("whisper-large-v3", "decode_32k"),
                                        ("qwen3-14b", "decode_32k")])
def test_production_cells_on_the_16x16_mesh(tmp_path, arch, shape):
    """A dense train cell and the production cases of a cut query head:
    cell B (llama3.2-3b's 24 query heads on 16 model ranks),
    whisper-large-v3's decode (20 heads) and qwen3-14b's (40 heads).
    Finite terms, a peak, the data-sheet basis, every group priced at the
    link it crosses (16 ranks span two 8-GPU nodes: InfiniBand)."""
    cfg = get_config(arch)
    rec = run_cell(arch, shape, False, tmp_path)
    assert rec["status"] == "ok" and rec["basis"] == "NVIDIA H100 SXM data sheet"
    r, m = rec["roofline"], rec["memory"]
    for key in ("compute_s", "memory_s", "collective_s", "bound_s", "model_flops"):
        assert math.isfinite(r[key]) and r[key] > 0, key
    assert r["bound_s"] == max(r["compute_s"], r["memory_s"], r["collective_s"])
    assert 0 < m["argument_bytes"] < m["peak_est_bytes"] and m["fits"] == (
        m["peak_est_bytes"] < H100_SXM.hbm_bytes)
    assert rec["n_devices"] == 256
    assert rec["link_rates"]["model"] == rec["link_rates"]["data"] == H100_SXM.inter_node_bw
    if shape == "prefill_32k":
        assert cfg.num_heads % 16 and rec["ops"]["kernels"]["flash_attention"]["calls"] == \
            cfg.num_layers
    if shape == "decode_32k":
        assert cfg.num_heads % 16 and m["cache_bytes"] > 0


def test_flash_substitution_prices_the_attention_interior():
    """``perf.flash_substitution``: a plain dry-run of a prefill prices the
    attention op by op, the default one K4's forward by its
    ``kernel_hbm_bytes``; the difference is the interior's traffic."""
    from repro_torch.kernels.flash_attention.ops import kernel_hbm_bytes
    from repro_torch.launch.perf import flash_substitution

    cfg = get_config("tinyllama-1.1b").smoke()
    shape = InputShape("p", 64, 4, "prefill")
    rec, plain = dry_run(cfg, shape, ONE), dry_run(cfg, shape, ONE, plain=True)
    sub = flash_substitution(rec, plain)
    per_call = kernel_hbm_bytes(4, 64, 64, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                                bytes_per_el=4)
    assert sub["k4_calls"] == cfg.num_layers and plain["ops"]["kernels"] == {}
    assert sub["k4_forward_bytes"] == cfg.num_layers * per_call
    assert sub["attention_interior_bytes"] == sub["plain_hbm_bytes"] - sub["kernel_hbm_bytes"] > 0
    assert sub["memory_s_plain"] > sub["memory_s_kernel"]


def test_production_meshes_and_link_rates():
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (one.shape, one.mesh_dim_names) == ((16, 16), ("data", "model"))
    assert (two.shape, two.mesh_dim_names) == ((2, 16, 16), ("pod", "data", "model"))
    assert H100_SXM.group_rate((2, 2), ("data", "model"), ["model"]) == 450e9
    assert H100_SXM.group_rate((1, 8), ("data", "model"), ["model"]) == 450e9
    assert H100_SXM.group_rate((16, 16), ("data", "model"), ["model"]) == 50e9
    assert H100_SXM.group_rate((2, 16, 16), ("pod", "data", "model"), ["pod", "data"]) == 50e9


def test_stand_ins_are_named():
    assert set(STAND_INS) == {"all_reduce_float", "item", "clip", "argmax", "moe_routing"}
    assert "STAND_INS" in dryrun.__doc__
    group = ShapeGroup(4)
    assert group.all_reduce_float(2.5) == 10.0 and group.all_reduce_float(2.5, "max") == 2.5
    assert group.sent_bytes == 16 and group.by_kind["all-reduce"] == 16


def test_shape_group_mirrors_group():
    """Shapes returned as Group returns them, bytes counted where Group
    counts them (size > 1), and any tensor off ``meta`` refused."""
    g = ShapeGroup(4, name="model")
    t = torch.empty((3, 5), device="meta")
    assert g.all_gather(t).shape == (4, 3, 5)
    assert g.reduce_scatter(torch.empty((4, 3, 5), device="meta")).shape == (3, 5)
    assert g.all_reduce(t) is t and g.broadcast(t, 0) is t
    g.send(t, 1)
    assert g.recv(t, 1) is t
    assert g.by_kind == {"all-gather": 60, "reduce-scatter": 240, "all-reduce": 60,
                         "broadcast": 60, "send": 60}
    assert g.sent_bytes == 480
    alone = ShapeGroup(1)
    alone.all_reduce(t)
    alone.all_gather(t)
    assert alone.sent_bytes == 0
    for fn in (g.all_reduce, g.all_gather, lambda x: g.broadcast(x, 0)):
        with pytest.raises(ValueError, match="meta"):
            fn(torch.zeros(3))
    assert {n for n in dir(Group) if not n.startswith("_")} <= \
        {n for n in dir(ShapeGroup) if not n.startswith("_")} | {"pg"}


# ---------------------------------------------------------------------------
# K4's and K5's meta routes
# ---------------------------------------------------------------------------
def test_kernel_meta_routes_price_and_never_launch():
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ops import kernel_flops, kernel_hbm_bytes
    from repro_torch.kernels.ssd_scan import ops as k5
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan

    flash_attention.launches = ssd_scan.launches = 0
    q = torch.empty((2, 64, 8, 32), dtype=torch.bfloat16, device="meta")
    kv = torch.empty((2, 64, 2, 32), dtype=torch.bfloat16, device="meta")
    x = torch.empty((2, 64, 4, 8), device="meta")
    la = torch.empty((2, 64, 4), device="meta")
    bc = torch.empty((2, 64, 16), device="meta")

    def step():
        o = flash_attention(q, kv, kv)
        y, h = ssd_scan(x, la, bc, bc, chunk=16)
        return o, y, h

    report = analyze_step(step)
    assert flash_attention.launches == 0 and ssd_scan.launches == 0
    assert report.kernels["flash_attention"] == {
        "calls": 1, "flops": kernel_flops(2, 64, 64, 8, 32),
        "hbm_bytes": kernel_hbm_bytes(2, 64, 64, 8, 2, 32, bytes_per_el=2)}
    assert report.kernels["ssd_scan"] == {
        "calls": 1, "flops": k5.kernel_flops(2, 64, 4, 8, 16),
        "hbm_bytes": k5.kernel_hbm_bytes(2, 64, 4, 8, 16)}
    o, y, h = step()
    assert o.device.type == y.device.type == h.device.type == "meta"
    assert (o.shape, y.shape, h.shape) == (q.shape, x.shape, (2, 4, 8, 16))


def test_kernel_meta_routes_refuse_what_the_cuda_routes_refuse():
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan

    wide = torch.empty((1, 8, 2, 264), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="head_dim up to 256"):
        flash_attention(wide, wide, wide)
    half = torch.empty((1, 8, 2, 16), dtype=torch.float16, device="meta")
    with pytest.raises(TypeError):
        flash_attention(half, half, half)
    x = torch.empty((1, 8, 2, 4), device="meta")
    la = torch.empty((1, 8, 2), device="meta")
    bc = torch.empty((1, 8, 4), device="meta")
    with pytest.raises(TypeError, match="float32"):
        ssd_scan(x.to(torch.bfloat16), la, bc, bc)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(torch.empty((1, 2, 8, 4), device="meta").transpose(1, 2), la, bc, bc)
    with pytest.raises(ValueError, match="N <= 256"):
        big = torch.empty((1, 8, 300), device="meta")
        ssd_scan(x, la, big, big)
