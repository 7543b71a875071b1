"""The port's ``encdec`` (whisper) and ``vlm`` (gated cross-attention)
families against the JAX package on the CPU.

``layer_norm``, ``sinusoidal_positions``, ``gelu_ffn``, biased and cross
attention with a cross cache; whisper-large-v3's ``smoke()`` model:
``encoder_forward``, prefill with ``frames`` and decode, the training
forward, the exact bf16 conversion of its parameter tree;
llama-3.2-vision-90b's ``smoke()`` model with its cross gates set to 0.5
on both sides (at their initial 0, ``tanh(0)`` multiplies the cross path
away): prefill with ``image_embeds`` and decode, the training forward,
and the prefill that raises without ``image_embeds`` (a deliberate
difference, ROADMAP.md queue 3).  The serving engine refuses both
families.  The JAX parameters are carried across with
``model_params_from_jax``; inputs come from numpy seeds; tolerance 2e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import ffn as jffn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import make_model as jax_make_model  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention, encdec, ffn, layers, make_model  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
WHISPER, VISION = "whisper-large-v3", "llama-3.2-vision-90b"


def close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **TOL)


def rnd(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def with_open_gates(jparams):
    """The reference's parameters with every cross gate at 0.5."""
    blocks = [dict(blk, gate_attn=jnp.full_like(blk["gate_attn"], 0.5),
                   gate_mlp=jnp.full_like(blk["gate_mlp"], 0.5)) if "gate_attn" in blk else blk
              for blk in jparams["blocks"]]
    return dict(jparams, blocks=blocks)


def carried(arch, seed=0):
    """(cfg, JAX model, JAX params, port model, port params) for a smoke config."""
    jcfg, cfg = jax_get_config(arch).smoke(), get_config(arch).smoke()
    jm = jax_make_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(seed))
    if cfg.family == "vlm":
        jparams = with_open_gates(jparams)
    params = convert.model_params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return cfg, jm, jparams, make_model(cfg, device="cpu"), params


@pytest.fixture(scope="module")
def whisper():
    return carried(WHISPER)


@pytest.fixture(scope="module")
def vision():
    return carried(VISION)


def test_layer_norm():
    x, w, b = rnd(2, 5, 32, seed=1, scale=3.0), rnd(32, seed=2), rnd(32, seed=3)
    x += 7.0  # a mean far from 0: the variance is the population one
    close(layers.layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), 1e-5),
          jlayers.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-5))


@pytest.mark.parametrize("seq,d", [(16, 32), (1500, 1280), (3, 2), (5, 3)])
def test_sinusoidal_positions(seq, d):
    close(layers.sinusoidal_positions(seq, d, device="cpu"), jlayers.sinusoidal_positions(seq, d))


def test_gelu_ffn_is_the_tanh_gelu():
    class B:  # the reference's Builder, as a dict of fixed arrays
        def param(self, name, shape, axes, **kw):
            return jnp.asarray(rnd(*shape, seed=len(name) + sum(shape), scale=0.5))
    jp = jffn.gelu_ffn_params(B(), 16, 64)
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = rnd(2, 7, 16, seed=5, scale=2.0)
    close(ffn.gelu_ffn(p, torch.from_numpy(x)), jffn.gelu_ffn(jp, jnp.asarray(x)))


def test_biased_cross_attention_with_a_cache(whisper):
    # the decoder's cross-attention alone: prefill stores the source's
    # keys in a cache of another length, decode attends them with one query
    cfg, _, jparams, _, params = whisper
    jcfg = jax_get_config(WHISPER).smoke()
    jp = jax.tree.map(lambda a: a[1], jparams["dec_blocks"]["xattn"])
    p = params["dec_blocks"][1]["xattn"]
    assert set(p) >= {"bq", "bk", "bv", "bo"}
    x, src = rnd(2, 5, cfg.d_model, seed=6), rnd(2, 16, cfg.d_model, seed=7)
    jcache = jattn.init_kv_cache(jcfg, 2, 16)
    cache = attention.init_kv_cache(cfg, 2, 16, device="cpu")
    jy, jcache = jattn.attention(jp, jnp.asarray(x), jcfg, kv_x=jnp.asarray(src), causal=False,
                                 cache=jcache, rope=False)
    y, again = attention.attention(p, torch.from_numpy(x), cfg, kv_x=torch.from_numpy(src),
                                   causal=False, cache=cache)
    assert again is cache
    close(y, jy)
    close(cache.k, jcache.k)
    assert cache.length.tolist() == [16, 16]
    x1 = rnd(2, 1, cfg.d_model, seed=8)
    jy, _ = jattn.attention(jp, jnp.asarray(x1), jcfg, kv_x=jnp.zeros((2, 1, cfg.d_model)),
                            causal=False, cache=jcache, cache_update=False, rope=False)
    y, _ = attention.attention(p, torch.from_numpy(x1), cfg, kv_x=torch.zeros(2, 1, cfg.d_model),
                               causal=False, cache=cache, cache_update=False)
    close(y, jy)


def test_encoder_forward(whisper):
    cfg, _, jparams, _, params = whisper
    frames = rnd(2, cfg.encoder_seq, cfg.d_model, seed=9)
    jcfg = jax_get_config(WHISPER).smoke()
    close(encdec.encoder_forward(params, torch.from_numpy(frames), cfg),
          jencdec.encoder_forward(jparams, jnp.asarray(frames), jcfg))


def test_whisper_prefill_and_decode(whisper):
    cfg, jm, jparams, model, params = whisper
    rng = np.random.default_rng(10)
    tokens = rng.integers(0, cfg.vocab_size, (1, 9)).astype(np.int32)
    frames = rnd(1, cfg.encoder_seq, cfg.d_model, seed=11)
    jlogits, jcaches = jm.prefill(jparams, {"tokens": jnp.asarray(tokens),
                                            "frames": jnp.asarray(frames)}, 32)
    logits, caches = model.prefill(params, torch.from_numpy(tokens), 32,
                                   frames=torch.from_numpy(frames))
    close(logits, jlogits)
    close(caches[1]["cross"].k, jcaches["cross"].k[1])
    tok = tokens[:, -1:]
    for step in range(4):
        pos = np.array([[9 + step]], np.int32)
        jlogits, jcaches = jm.decode_step(jparams, jnp.asarray(tok), jnp.asarray(pos), jcaches)
        logits, caches = model.decode_step(params, torch.from_numpy(tok), torch.from_numpy(pos),
                                           caches)
        close(logits, jlogits)
        tok = np.array(jnp.argmax(jlogits, axis=-1), np.int32)[:, None]
    close(caches[0]["self"].k, jcaches["self"].k[0])


def test_whisper_training_forward(whisper):
    cfg, jm, jparams, model, params = whisper
    tokens = np.random.default_rng(12).integers(0, cfg.vocab_size, (2, 11)).astype(np.int32)
    frames = rnd(2, cfg.encoder_seq, cfg.d_model, seed=13)
    jhidden, _, _ = jm.forward(jparams, {"tokens": jnp.asarray(tokens),
                                         "frames": jnp.asarray(frames)})
    aux = {}
    hidden, _ = model.forward(params, torch.from_numpy(tokens), frames=torch.from_numpy(frames),
                              aux=aux)
    close(model.logits(params, hidden), jm.logits(jparams, jhidden))
    assert all(float(v) == 0.0 for v in aux.values()) and len(aux) == 4


def test_encdec_bf16_params_convert_exactly():
    cfg = get_config(WHISPER).smoke().replace(dtype="bfloat16", param_dtype="bfloat16")
    jcfg = jax_get_config(WHISPER).smoke().replace(dtype="bfloat16", param_dtype="bfloat16")
    jparams = jax.tree.map(np.asarray, jax_make_model(jcfg).init(jax.random.PRNGKey(3)))
    params = convert.model_params_from_jax(jparams, cfg, "cpu")
    assert len(params["enc_blocks"]) == cfg.encoder_layers and len(params["dec_blocks"]) == 2
    pairs = [(params["embed"], jparams["embed"]), (params["dec_pos"], jparams["dec_pos"]),
             (params["enc_ln_out"]["w"], jparams["enc_ln_out"]["w"]),
             (params["dec_ln_out"]["b"], jparams["dec_ln_out"]["b"])]
    for i in range(cfg.encoder_layers):
        pairs += [(params["enc_blocks"][i]["attn"]["wq"], jparams["enc_blocks"]["attn"]["wq"][i]),
                  (params["enc_blocks"][i]["mlp"]["w1"], jparams["enc_blocks"]["mlp"]["w1"][i])]
    for i in range(cfg.num_layers):
        pairs += [(params["dec_blocks"][i]["xattn"]["wk"],
                   jparams["dec_blocks"]["xattn"]["wk"][i]),
                  (params["dec_blocks"][i]["ln_xattn"]["w"],
                   jparams["dec_blocks"]["ln_xattn"]["w"][i])]
    for got, want in pairs:
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_vision_prefill_and_decode(vision):
    cfg, jm, jparams, model, params = vision
    cross = [i for i, layer in enumerate(params["layers"]) if "xattn" in layer]
    assert cross == [1, 3] and float(params["layers"][1]["gate_attn"]) == 0.5
    rng = np.random.default_rng(14)
    tokens = rng.integers(0, cfg.vocab_size, (2, 11)).astype(np.int32)
    image = rnd(2, cfg.num_image_tokens, cfg.d_model, seed=15)
    jlogits, jcaches = jm.prefill(jparams, {"tokens": jnp.asarray(tokens),
                                            "image_embeds": jnp.asarray(image)}, 32)
    logits, caches = model.prefill(params, torch.from_numpy(tokens), 32,
                                   image_embeds=torch.from_numpy(image))
    close(logits, jlogits)
    close(caches[1]["cross"].k, jcaches["blocks"][1]["cross"].k[0])
    tok = tokens[:, -1:]
    for step in range(4):
        pos = np.full((2, 1), 11 + step, np.int32)
        jlogits, jcaches = jm.decode_step(jparams, jnp.asarray(tok), jnp.asarray(pos), jcaches)
        logits, caches = model.decode_step(params, torch.from_numpy(tok), torch.from_numpy(pos),
                                           caches)
        close(logits, jlogits)
        tok = np.array(jnp.argmax(jlogits, axis=-1), np.int32)[:, None]


def test_vision_training_forward(vision):
    cfg, jm, jparams, model, params = vision
    tokens = np.random.default_rng(16).integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    image = rnd(2, cfg.num_image_tokens, cfg.d_model, seed=17)
    jhidden, _, _ = jm.forward(jparams, {"tokens": jnp.asarray(tokens),
                                         "image_embeds": jnp.asarray(image)})
    hidden, _ = model.forward(params, torch.from_numpy(tokens),
                              image_embeds=torch.from_numpy(image))
    close(model.logits(params, hidden), jm.logits(jparams, jhidden))


def test_vision_prefill_without_image_embeds_raises(vision):
    _, _, _, model, params = vision
    with pytest.raises(ValueError, match="image_embeds.*ROADMAP"):
        model.prefill(params, torch.zeros((1, 5), dtype=torch.int64), 16)


@pytest.mark.parametrize("arch", [WHISPER, VISION])
def test_engine_refuses_families_with_a_second_input(arch):
    model = make_model(get_config(arch).smoke(), device="cpu")
    with pytest.raises(ValueError, match="Model.prefill"):
        ServingEngine(model, model.init(0), slots=2, max_len=32)
