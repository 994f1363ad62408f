"""The port's LM serving path (``repro_torch.models``,
``repro_torch.serve.engine``) against the JAX package's, on the CPU.

For the reduced ChatGLM3, Gemma-3 (window 8 across its 5:1 local:global
group), StarCoder2, Qwen3-MoE (8 experts, top-2 renormalized, QK-norm),
Mixtral (4 experts, top-2, window 8), MiniCPM3 (MLA: expanded prefill,
absorbed decode), Jamba (7 Mamba + 1 attention layer, MoE on every other
layer), RWKV-6 (time mix and channel mix, no attention), InternVL2 (VLM:
4 patch embeddings before the tokens) and Whisper (audio: a 2-layer
bidirectional encoder over 12 frame embeddings, cross-attention in every
decoder layer) configs in float32, JAX's ``init_params(PRNGKey(0))`` is
converted with ``convert.from_jax_lm_params`` and both packages run the
same numpy tokens, and the same numpy patches or frames (``extras``):

  * ``forward_hidden`` (its MoE load-balance loss at rtol 1e-5; a VLM's
    hidden states with the patch positions first), ``prefill`` (cache
    contents: sequence entries, recurrent states and cross K/V;
    ``last_logits``; t0, P + S for a VLM) and four teacher-forced ``decode_step`` logits at rtol
    = atol = 1e-4 (fp32 matmuls summed in another order; the port's prefill
    attention is the quadratic plain version on the CPU, JAX's the blocked
    online softmax; the port's recurrences run in order, JAX's Mamba scan
    associatively);
  * ``LMServer.generate`` tokens against JAX's ``LMServer``, row by row up to
    the first step whose JAX top-2 logit gap is 1e-3 or less (past a near
    tie the two may rightly pick different tokens); two successive
    ``generate`` calls on one server (its static cache and state reused)
    against two fresh servers (bit for bit) and against JAX's;
  * ``prefill`` into a cache the caller owns (a server's static cache)
    against a fresh one, bit for bit: the prompt's sequence entries, zeros
    past it, and the recurrent states;
  * decode after prefill(S-1) against forward(S)'s last logits at capacity
    factor 8 (JAX's ``tests/test_arch_smoke.py`` check, its 2e-2 bound).

ChatGLM3 in bfloat16 is held to JAX's own bound for bf16 paths
(``tests/test_arch_smoke.py``): max|delta| <= 2e-2 max|ref|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import params as JP
from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.models import lm as JLM
from repro.serve.engine import LMServer as JLMServer
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.convert import from_jax_lm_params
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.models import transformer as TT
from repro_torch.serve.engine import LMServer, ServeConfig

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 16
N_DECODE = 4
SERVE = dict(max_batch=B, prompt_len=S, cache_len=32, max_new_tokens=6)
GAP = 1e-3


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


def _jax_params(cfg):
    """JAX's init_params(PRNGKey(0)) values (compiled: eager init takes
    seconds per arch), and their numpy copies."""
    jp = jax.jit(lambda key: JP.values(JLM.init_params(key, cfg)))(jax.random.PRNGKey(0))
    return jp, jax.tree_util.tree_map(np.asarray, jp)


def _prompts(cfg, rng):
    return [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n in (11, 16)]


def _extras(cfg, rng, b=B):
    """The VLM's patch or the audio model's frame embeddings (float32 normal
    draws, as JAX's launcher makes them); {} for the other families."""
    if cfg.family == "vlm":
        return {"patches": rng.normal(size=(b, cfg.num_patches, cfg.d_model))
                .astype(np.float32)}
    if cfg.family == "audio":
        return {"frames": rng.normal(size=(b, cfg.encoder_seq, cfg.d_model))
                .astype(np.float32)}
    return {}


def _t0(cfg, s=S):
    """prefill's t0: the prompt's length, after a VLM's patches."""
    return s + (cfg.num_patches if cfg.family == "vlm" else 0)


def _torch_batch(tokens, extras):
    return {"tokens": torch.from_numpy(tokens),
            **{k: torch.from_numpy(v) for k, v in extras.items()}}


def _jax_batch(tokens, extras):
    return {"tokens": jnp.asarray(tokens), **{k: jnp.asarray(v) for k, v in extras.items()}}


def _jax_greedy(srv, jp, prompts, extras):
    """JAX's greedy generation as ``LMServer.generate`` runs it (through the
    server's own compiled prefill and decode), with the top-2 logit gap of
    every step: (tokens (B, N), gaps (B, N))."""
    scfg = srv.scfg
    toks = np.zeros((scfg.max_batch, scfg.prompt_len), np.int32)
    for i, pr in enumerate(prompts):
        toks[i, -len(pr):] = pr
    cache, logits, t = srv._prefill(jp, _jax_batch(toks, extras))
    out, gaps = [], []
    for _ in range(scfg.max_new_tokens):
        lg = np.asarray(logits, np.float32)
        top2 = np.sort(lg, axis=-1)[:, -2:]
        gaps.append(top2[:, 1] - top2[:, 0])
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
        out.append(np.asarray(tok[:, 0]))
        logits, cache = srv._decode(jp, cache, tok, t)
        t = t + 1
    return np.stack(out, 1), np.stack(gaps, 1)


@pytest.fixture(scope="module", params=ARCHS)
def arch_case(request):
    """JAX's outputs for one reduced arch in float32, computed once: the
    prompt batch has the server's shape, so one compiled prefill and one
    compiled decode serve every JAX call."""
    arch = request.param
    cfg = jget_reduced(arch, dtype="float32")
    jp, jp_np = _jax_params(cfg)
    srv = JLMServer(jp, cfg, JServeConfig(**SERVE))
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    extras = _extras(cfg, rng)
    fwd = jax.jit(lambda p, b: JLM.forward_hidden(p, b, cfg))
    hidden, aux = (np.array(a) for a in fwd(jp, _jax_batch(tokens, extras)))
    cache, last, t = srv._prefill(jp, _jax_batch(tokens, extras))
    # copies: the compiled decode donates the cache it is given
    cache_np, last, t0 = jax.tree_util.tree_map(np.array, cache), np.array(last), int(t)
    steps = rng.integers(0, cfg.vocab_size, (N_DECODE, B, 1)).astype(np.int32)
    dec = []
    for tok in steps:
        logits, cache = srv._decode(jp, cache, jnp.asarray(tok), t)
        dec.append(np.array(logits))
        t = t + 1
    served = []
    for prompts in (_prompts(cfg, rng), _prompts(cfg, rng)):
        gen, _ = srv.generate(prompts, extras=extras or None)
        greedy, gaps = _jax_greedy(srv, jp, prompts, extras)
        np.testing.assert_array_equal(gen, greedy)
        served.append((prompts, gen, gaps))
    (prompts, gen, gaps), second = served
    return dict(arch=arch, cfg=get_reduced(arch, dtype="float32"),
                params=from_jax_lm_params(jp_np), tokens=tokens, extras=extras, steps=steps,
                hidden=hidden, aux=aux, last=last, t0=t0, cache=cache_np, decode=dec,
                prompts=prompts, generated=gen, gaps=gaps, second=second)


def _assert_tokens_match(got, want, gaps):
    """Row by row up to the first near tie of JAX's logits; at least half
    the tokens compared."""
    assert got.dtype == np.int32 and got.shape == want.shape
    compared = 0
    for row in range(got.shape[0]):
        for step in range(got.shape[1]):
            if gaps[row, step] <= GAP:
                break
            assert got[row, step] == want[row, step], (row, step)
            compared += 1
    assert compared >= got.size // 2


def test_forward_hidden_matches_jax(arch_case):
    c = arch_case
    hidden, aux = TLM.forward_hidden(c["params"], _torch_batch(c["tokens"], c["extras"]),
                                     c["cfg"])
    assert tuple(hidden.shape) == (B, _t0(c["cfg"]), c["cfg"].d_model)
    _close(hidden, c["hidden"])
    assert aux.dtype == torch.float32 and aux.shape == ()
    _close(aux, c["aux"], dict(rtol=1e-5, atol=0))
    assert (float(aux) > 0) == bool(c["cfg"].num_experts)


def test_prefill_and_decode_match_jax(arch_case):
    c = arch_case
    cache, last, t0 = TLM.prefill(c["params"], _torch_batch(c["tokens"], c["extras"]),
                                  c["cfg"], SERVE["cache_len"])
    assert t0 == c["t0"] == _t0(c["cfg"])
    _close(last, c["last"])
    assert len(cache) == len(c["cache"])
    for got, want in zip(cache, c["cache"]):
        assert sorted(got) == sorted(want)
        for key in want:
            assert tuple(got[key].shape) == want[key].shape
            assert str(got[key].dtype).removeprefix("torch.") == str(want[key].dtype)
            _close(got[key], want[key])
    t = t0
    for tok, want in zip(c["steps"], c["decode"]):
        logits, cache = TLM.decode_step(c["params"], cache, torch.from_numpy(tok), t,
                                        c["cfg"])
        _close(logits, want)
        t += 1


def test_generate_matches_jax_server(arch_case):
    c = arch_case
    srv = LMServer(c["params"], c["cfg"], ServeConfig(**SERVE), device="cpu")
    got, stats = srv.generate(c["prompts"], extras=c["extras"] or None)
    assert stats["prefill_s"] > 0 and stats["decode_s_per_token"] > 0
    _assert_tokens_match(got, c["generated"], c["gaps"])


def test_successive_generates_match_fresh_servers_and_jax(arch_case):
    """One server's second ``generate`` reuses its static cache, position
    and output: it gives a fresh server's tokens bit for bit, and both
    calls give JAX's."""
    c = arch_case
    srv = LMServer(c["params"], c["cfg"], ServeConfig(**SERVE), device="cpu")
    extras = c["extras"] or None
    first, _ = srv.generate(c["prompts"], extras=extras)
    prompts2, gen2, gaps2 = c["second"]
    second, _ = srv.generate(prompts2, extras=extras)
    for prompts, got in ((c["prompts"], first), (prompts2, second)):
        fresh = LMServer(c["params"], c["cfg"], ServeConfig(**SERVE), device="cpu")
        np.testing.assert_array_equal(got, fresh.generate(prompts, extras=extras)[0])
    _assert_tokens_match(first, c["generated"], c["gaps"])
    _assert_tokens_match(second, gen2, gaps2)
    assert srv.captures == 0  # no graphs on the CPU


def test_prefill_into_an_owned_cache_matches_a_fresh_one(arch_case):
    c = arch_case
    batch = _torch_batch(c["tokens"], c["extras"])
    fresh, last, t0 = TLM.prefill(c["params"], batch, c["cfg"], SERVE["cache_len"])
    owned = TLM.init_cache(c["cfg"], B, SERVE["cache_len"])
    gen = torch.Generator().manual_seed(1)
    for leaf in owned:  # a used cache: every slot written
        for w in leaf.values():
            w.copy_(torch.randn(w.shape, generator=gen))
    got, last2, t2 = TLM.prefill(c["params"], batch, c["cfg"], SERVE["cache_len"],
                                 cache=owned)
    assert got is owned and t2 == t0 == _t0(c["cfg"]) and torch.equal(last2, last)
    for a, b in zip(got, fresh):
        assert sorted(a) == sorted(b)
        for key in a:
            assert torch.equal(a[key], b[key])
            if key in TT.SEQ_CACHE_KEYS:
                assert not a[key][:, :, t0:].any()


def test_kernel_mode_raises_on_cpu_and_launches_nothing(arch_case):
    """An arch with attention reaches the flash kernel, which raises on CPU
    tensors; an attention-free one (RWKV-6) reaches no kernel and runs."""
    c = arch_case
    before = FA.launches
    batch = _torch_batch(c["tokens"], c["extras"])
    if any(c["cfg"].mixer_kind(i) == "attn" for i in range(c["cfg"].group_size)):
        with pytest.raises(RuntimeError, match="CUDA"):
            TLM.prefill(c["params"], batch, c["cfg"], S + 8, kernel_mode="kernel")
    else:
        _, last, _ = TLM.prefill(c["params"], batch, c["cfg"], S + 8, kernel_mode="kernel")
        _close(last, c["last"])
    assert FA.launches == before


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_after_prefill_matches_forward(arch):
    """JAX's ``tests/test_arch_smoke.py`` check on the port: at capacity
    factor 8 (no MoE drops), decode after prefill(S-1) gives forward(S)'s
    last logits within 2e-2 max|ref| (a VLM's patches and an audio model's
    frames in both)."""
    cfg = get_reduced(arch, dtype="float32", capacity_factor=8.0)
    params = TLM.init_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab_size, (B, S))
    extras = {k: torch.from_numpy(v) for k, v in _extras(cfg, rng).items()}
    tokens = torch.from_numpy(tokens)
    cache, _, t0 = TLM.prefill(params, {"tokens": tokens[:, :-1], **extras}, cfg,
                               _t0(cfg) + 8)
    assert t0 == _t0(cfg, S - 1)
    logits, _ = TLM.decode_step(params, cache, tokens[:, -1:], t0, cfg)
    hidden, _ = TLM.forward_hidden(params, {"tokens": tokens, **extras}, cfg)
    ref = TLM.logits_fn(params, hidden[:, -1], cfg)
    assert float((logits - ref).abs().max() / ref.abs().max()) < 2e-2


def test_bf16_chatglm3_within_jax_bf16_bound():
    """ChatGLM3-reduced in its bf16 model dtype: the same converted weights,
    prefill logits and decode within 2e-2 max|ref|."""
    cfg_j = jget_reduced("chatglm3-6b")
    assert cfg_j.dtype == "bfloat16"
    jp, jp_np = _jax_params(cfg_j)
    tp = from_jax_lm_params(jp_np)
    assert tp["blocks"][0]["mixer"]["wq"].dtype == torch.bfloat16
    assert tp["final_norm"].dtype == torch.float32
    # JAX draws in fp32 and rounds to bf16: converting its fp32 tree with
    # dtype=bf16 gives the same tree bit for bit
    f32 = _jax_params(jget_reduced("chatglm3-6b", dtype="float32"))[1]
    cast = from_jax_lm_params(f32, dtype=torch.bfloat16)
    for a, b in zip(jax.tree_util.tree_leaves(tp), jax.tree_util.tree_leaves(cast)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    tokens = np.random.default_rng(3).integers(0, cfg_j.vocab_size, (B, S)).astype(np.int32)
    jcache, jlast, t0 = JLM.prefill(jp, {"tokens": jnp.asarray(tokens[:, :-1])}, cfg_j, S + 4)
    jdec, _ = JLM.decode_step(jp, jcache, jnp.asarray(tokens[:, -1:]), t0, cfg_j)
    cfg = get_reduced("chatglm3-6b")
    cache, last, t = TLM.prefill(tp, {"tokens": torch.from_numpy(tokens[:, :-1])}, cfg, S + 4)
    dec, _ = TLM.decode_step(tp, cache, torch.from_numpy(tokens[:, -1:]), t, cfg)
    for got, want in ((last, jlast), (dec, jdec)):
        assert got.dtype == torch.bfloat16
        want = np.asarray(want, np.float32)
        assert np.abs(_np(got) - want).max() <= 2e-2 * np.abs(want).max()


def test_kv_padding_is_semantics_preserving():
    """Counterpart of the JAX test of the same name: kv_pad_to (tied KV
    copies) leaves forward_hidden unchanged, and the padded cache has the
    padded head count, as JAX's."""
    cfg0 = get_reduced("starcoder2-15b", dtype="float32")
    cfg1 = get_reduced("starcoder2-15b", dtype="float32", kv_pad_to=8)
    assert cfg1.kv_heads_effective == 8 and cfg0.kv_heads_effective == 2
    params = TLM.init_params(torch.Generator().manual_seed(0), cfg0)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg0.vocab_size, (B, S)))
    h0, _ = TLM.forward_hidden(params, {"tokens": tokens}, cfg0)
    h1, _ = TLM.forward_hidden(params, {"tokens": tokens}, cfg1)
    np.testing.assert_allclose(_np(h0), _np(h1), rtol=1e-5, atol=1e-5)
    cache, _, _ = TLM.prefill(params, {"tokens": tokens}, cfg1, S)
    jcache = JLM.init_cache(jget_reduced("starcoder2-15b", dtype="float32", kv_pad_to=8),
                            B, S)
    assert tuple(cache[0]["k"].shape) == JP.values(jcache)[0]["k"].shape


def test_cache_overflow_raises():
    """JAX clamps a decode write past the cache onto its last slot; the port
    refuses the configuration up front, and a stray write raises."""
    cfg = get_reduced("chatglm3-6b", dtype="float32")
    params = TLM.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="exceeds cache_len"):
        LMServer(params, cfg, ServeConfig(max_batch=1, prompt_len=16, cache_len=20,
                                          max_new_tokens=5), device="cpu")
    LMServer(params, cfg, ServeConfig(max_batch=1, prompt_len=16, cache_len=21,
                                      max_new_tokens=5), device="cpu")
    cache = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="outside a cache"):
        TL._cache_update(cache, torch.ones(1, 1, 2, 8), 4)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_shapes_and_dtypes_match_jax(arch):
    """The port's random init has JAX's tree, shapes and dtypes (the
    stacked block norms cast to the model dtype, final_norm fp32)."""
    cfg_j = jget_reduced(arch)
    jp = jax.eval_shape(lambda key: JP.values(JLM.init_params(key, cfg_j)),
                        jax.random.PRNGKey(0))
    tp = TLM.init_params(torch.Generator().manual_seed(0), get_reduced(arch))
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl = jax.tree_util.tree_leaves_with_path(tp)
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [jax.tree_util.keystr(p) for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        assert a.shape == tuple(b.shape), jax.tree_util.keystr(path)
        assert str(a.dtype) == str(b.dtype).removeprefix("torch."), jax.tree_util.keystr(path)
    # JAX's scale rule: std (1 / shape[0]) ** 0.5 of the per-layer shape (the
    # first block's first projection from d_model: GQA's wq, MLA's w_dq,
    # Mamba's in_proj, RWKV's wr)
    mixer = tp["blocks"][0]["mixer"]
    w = mixer[next(n for n in ("wq", "w_dq", "in_proj", "wr") if n in mixer)].float()
    assert abs(float(w.std()) - (1 / cfg_j.d_model) ** 0.5) < 0.1 * (1 / cfg_j.d_model) ** 0.5


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_derived_properties_match_jax(arch):
    for get, jget in ((get_config, jget_config), (get_reduced, jget_reduced)):
        cfg, cfg_j = get(arch), jget(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
        assert (cfg.head_dim_, cfg.kv_heads_effective, cfg.group_size, cfg.num_groups) == (
            cfg_j.head_dim_, cfg_j.kv_heads_effective, cfg_j.group_size, cfg_j.num_groups)
        for i in range(cfg.num_layers):
            assert (cfg.window_for_layer(i), cfg.mixer_kind(i), cfg.ffn_kind(i)) == (
                cfg_j.window_for_layer(i), cfg_j.mixer_kind(i), cfg_j.ffn_kind(i))


@pytest.mark.parametrize("arch", ("internvl2-26b", "whisper-base"))
def test_vlm_and_audio_refuse_a_call_without_their_extras(arch):
    """A VLM without its patches or an audio model without its frames is
    refused with a ValueError naming the extra (not a KeyError), by
    forward_hidden, prefill and LMServer.generate; so is an extra of
    another shape."""
    cfg = get_reduced(arch, dtype="float32")
    name = TLM.extra_input(cfg, B)[0]
    params = TLM.init_params(torch.Generator().manual_seed(0), cfg)
    batch = {"tokens": torch.zeros((B, S), dtype=torch.int32)}
    with pytest.raises(ValueError, match=name):
        TLM.forward_hidden(params, batch, cfg)
    with pytest.raises(ValueError, match=name):
        TLM.prefill(params, batch, cfg, 64)
    srv = LMServer(params, cfg, ServeConfig(**SERVE), device="cpu")
    prompts = [np.arange(1, 9, dtype=np.int32)] * B
    for extras in (None, {}, {"other": np.zeros(3)}):
        with pytest.raises(ValueError, match=name):
            srv.generate(prompts, extras=extras)
    good = _extras(cfg, np.random.default_rng(0))[name]
    for bad in (good[:1], good[:, :-1], good[..., :-1]):
        with pytest.raises(ValueError, match="of shape"):
            srv.generate(prompts, extras={name: bad})
    srv.generate(prompts, extras={name: good})


def test_layer_helpers_match_jax():
    """rms_norm, partial RoPE and the three MLP kinds on the same inputs."""
    from repro.models import layers as JL

    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    _close(TL.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(scale)), dict(rtol=1e-6, atol=1e-6))
    pos = np.tile(np.arange(7), (2, 1))
    for frac in (1.0, 0.5):
        _close(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4, frac),
               JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4, frac),
               dict(rtol=1e-5, atol=1e-5))
    for mlp in ("swiglu", "geglu", "gelu"):
        cfg_j = jget_reduced("chatglm3-6b", dtype="float32", mlp_type=mlp)
        p = jax.tree_util.tree_map(np.asarray,
                                   JP.values(JL.mlp_init(jax.random.PRNGKey(1), cfg_j)))
        h = rng.normal(size=(2, 5, cfg_j.d_model)).astype(np.float32)
        _close(TL.mlp_apply(from_jax_lm_params(p), torch.from_numpy(h),
                            get_reduced("chatglm3-6b", dtype="float32", mlp_type=mlp)),
               JL.mlp_apply(p, jnp.asarray(h), cfg_j), dict(rtol=1e-5, atol=1e-5))


def test_launcher_serves_reduced_lm_on_cpu(capsys):
    from repro_torch.launch.serve import main

    for arch in ("chatglm3-6b", "qwen3-moe-30b-a3b", "minicpm3-4b", "jamba-v0.1-52b",
                 "rwkv6-1.6b"):
        main(["--arch", arch, "--reduced", "--device", "cpu", "--max-new", "3"])
        out = capsys.readouterr().out
        assert "generated:" in out and "ms/token" in out
    with pytest.raises(SystemExit):
        main(["--arch", "chatglm3-6b", "--gnn", "gin", "--device", "cpu"])


@pytest.mark.parametrize("arch", ("internvl2-26b", "whisper-base"))
def test_launcher_serves_reduced_vlm_and_audio_on_cpu(arch, capsys):
    """The launcher draws the patches or frames as JAX's does and serves."""
    from repro_torch.launch.serve import main

    main(["--arch", arch, "--reduced", "--device", "cpu", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "generated:" in out and "ms/token" in out
