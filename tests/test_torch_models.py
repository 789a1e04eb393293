"""The port's transformer family (``repro_torch.models``, ``repro_torch.configs``)
against the JAX package on the CPU.

The same inputs, made from a seed with numpy, go through ``repro.models``
(jitted, no mesh, as ``tests/test_arch_smoke.py`` runs it) and the port;
the reference's parameters are carried across with
``convert.lm_from_arrays``.  Tolerances:

- the layers (norms, RoPE, M-RoPE, flash attention, decode attention,
  MLP, unembedding): 2e-5, the reference's own in
  ``tests/test_flash_attention.py``;
- ``moe_apply``: 1e-5 on the outputs; with a capacity factor that drops
  tokens, the counts, the dispatch buffers' token ids and the dropped
  copies exactly;
- each of the seven smoke configs: prefill logits 1e-4; three greedy
  ``decode_step``s 2e-3, which absorbs the bfloat16 KV cache (a 1-ulp
  difference of a cached float32 value rounds to a different bfloat16);
  the cache index exactly;
- four smoke configs in their full-size configs' dtypes (bfloat16
  activations, grok's bfloat16 parameters), against the reference jitted
  without excess precision (rounding after every op, as the port does):
  logits 1e-6, the bfloat16 KV caches exactly;
- the decode-consistency rule of ``tests/test_models.py`` (prefill +
  decode logits equal ``forward``'s, float32 cache) at its 2e-4, in the
  port alone.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.models import layers as JL
from repro.models import model_zoo as j_zoo
from repro.models import moe as JM
from repro.models import encdec as JE
from repro.models import transformer as JT
from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, pad_to_multiple
from repro_torch.convert import lm_from_arrays
from repro_torch.models import layers as TL
from repro_torch.models import model_zoo as t_zoo
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT

CPU = "cpu"
LAYER_TOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a)) if dtype is None else torch.tensor(np.array(a), dtype=dtype)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


# ------------------------------------------------------------------ layers ---

def test_rmsnorm_and_layernorm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    scale = rng.standard_normal(24).astype(np.float32)
    bias = rng.standard_normal(24).astype(np.float32)
    _close(TL.rmsnorm({"scale": _t(scale)}, _t(x), 1e-6),
           JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6), LAYER_TOL)
    _close(TL.layernorm({"scale": _t(scale), "bias": _t(bias)}, _t(x)),
           JL.layernorm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                        jnp.asarray(x)), LAYER_TOL)
    # bfloat16 in, float32 inside, bfloat16 out
    got = TL.rmsnorm({"scale": _t(scale)}, _t(x).to(torch.bfloat16))
    want = JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    _close(got.float(), want.astype(jnp.float32), 0.0)


def test_rope_and_mrope():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 1000, (2, 6))
    _close(TL.apply_rope(_t(x), _t(pos), 1e6),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos, jnp.int32), 1e6), LAYER_TOL)
    pos3 = rng.integers(0, 1000, (3, 2, 6))          # distinct t/h/w components
    _close(TL.apply_mrope(_t(x), _t(pos3), 1e4, (3, 3, 2)),
           JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos3, jnp.int32), 1e4, (3, 3, 2)),
           LAYER_TOL)
    same = np.stack([pos, pos, pos])
    _close(TL.apply_mrope(_t(x), _t(same), 1e4, (3, 3, 2)),
           TL.apply_rope(_t(x), _t(pos), 1e4), 1e-6)
    with pytest.raises(ValueError, match="sections"):
        TL.apply_mrope(_t(x), _t(pos3), 1e4, (3, 3, 3))


def _qkv(b, t, s, h, kv, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, h, hd)).astype(np.float32),
            rng.standard_normal((b, s, kv, hd)).astype(np.float32),
            rng.standard_normal((b, s, kv, hd)).astype(np.float32))


# (t, s, q_chunk, k_chunk, q_offset): chunk multiples, padded query and key
# chunks, a continuation prefill (t < s, q_offset = s - t)
SDPA_CASES = [(16, 16, 4, 8, 0), (17, 17, 8, 5, 0), (9, 9, 16, 16, 0), (12, 20, 5, 6, 8)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", SDPA_CASES, ids=lambda c: "t{}s{}qc{}kc{}o{}".format(*c))
def test_sdpa_variants(case, causal):
    t, s, qc, kc, off = case
    q, k, v = _qkv(2, t, s, 4, 2, 8, seed=t * 31 + s)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(_t, (q, k, v))
    _close(TL._sdpa_flash(tq, tk, tv, causal=causal, q_chunk=qc, k_chunk=kc, q_offset=off),
           JL._sdpa_flash(jq, jk, jv, causal=causal, q_chunk=qc, k_chunk=kc, q_offset=off),
           LAYER_TOL)


def _attn_params(cfg, seed):
    jp = JL.attn_init(jax.random.PRNGKey(seed), cfg)
    return jp, _leaves(jp)


def _leaves(tree):
    return TL.tree_map(lambda a: torch.from_numpy(np.array(a)),
                       jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("variant", ["rope", "mrope", "qk_norm"])
def test_attention_decode(variant):
    """The cache written at its index, entries past it masked, positions
    broadcast (to [3, B, 1] under M-RoPE); then a prefill through
    ``attention`` and ``attention_prefill`` (padding the cache)."""
    kw = {"rope": dict(qkv_bias=True), "mrope": dict(qkv_bias=True, mrope_sections=(2, 1, 1)),
          "qk_norm": dict(qk_norm=True)}[variant]
    jcfg = JL.AttnConfig(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, q_chunk=4,
                         k_chunk=4, rope_theta=1e4, **kw)
    assert jcfg.attn_impl == "flash"      # the port's one recurrence
    tcfg = TL.AttnConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items()
                            if k != "attn_impl"})
    jp, tp = _attn_params(jcfg, 3)
    rng = np.random.default_rng(4)
    b, s, idx = 2, 10, 6
    x = rng.standard_normal((b, 1, 32)).astype(np.float32)
    kc = rng.standard_normal((b, s, 2, 8)).astype(np.float32)
    vc = rng.standard_normal((b, s, 2, 8)).astype(np.float32)
    jy, (jk, jv) = JL.attention_decode(jp, jcfg, jnp.asarray(x), jnp.int32(idx),
                                       (jnp.asarray(kc), jnp.asarray(vc)), jnp.int32(idx))
    ty, (tk, tv) = TL.attention_decode(tp, tcfg, _t(x), idx, (_t(kc), _t(vc)), idx)
    _close(ty, jy, LAYER_TOL)
    _close(tk, jk, LAYER_TOL)
    _close(tv, jv, LAYER_TOL)
    with pytest.raises(IndexError):
        TL.attention_decode(tp, tcfg, _t(x), s, (_t(kc), _t(vc)), s)
    # prefill
    xs = rng.standard_normal((b, 7, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7), (b, 7))
    if variant == "mrope":
        pos = rng.integers(0, 50, (3, b, 7))
    _close(TL.attention(tp, tcfg, _t(xs), _t(pos)),
           JL.attention(jp, jcfg, jnp.asarray(xs), jnp.asarray(pos, jnp.int32)), LAYER_TOL)
    ty, (tk, tv) = TL.attention_prefill(tp, tcfg, _t(xs), _t(pos), 12)
    jy, (jk, jv) = JL.attention_prefill(jp, jcfg, jnp.asarray(xs),
                                        jnp.asarray(pos, jnp.int32), 12)
    assert tuple(tk.shape) == (b, 12, 2, 8)
    for got, want in ((ty, jy), (tk, jk), (tv, jv)):
        _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("gated", [True, False])
def test_mlp_embed_unembed(gated):
    jp = JL.mlp_init(jax.random.PRNGKey(5), 24, 40, gated=gated)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    _close(TL.mlp(_leaves(jp), _t(x)), JL.mlp(jp, jnp.asarray(x)), LAYER_TOL)
    je = JL.embedding_init(jax.random.PRNGKey(7), 50, 24)
    te = _leaves(je)
    toks = rng.integers(0, 50, (2, 5))
    _close(TL.embed(te, _t(toks)), JL.embed(je, jnp.asarray(toks)), 0.0)
    _close(TL.unembed(te, _t(x)), JL.unembed(je, jnp.asarray(x)), LAYER_TOL)


# --------------------------------------------------------------------- MoE ---

def _moe_case(seed=8, n_experts=8):
    jp = JM.moe_init(jax.random.PRNGKey(seed), 16, 24, n_experts)
    x = np.random.default_rng(seed).standard_normal((2, 40, 16)).astype(np.float32)
    return jp, _leaves(jp), x


def _reference_dispatch(jp, x, top_k, n_experts, cf):
    """The reference's routing (its router, softmax and ``lax.top_k``), and
    the dispatch it implies in numpy: the stable sort by expert, the counts,
    each slot's token and each sorted copy's fit."""
    xf = jnp.asarray(x.reshape(-1, x.shape[-1]))
    probs = jax.nn.softmax(xf @ jp["router"]["w"], axis=-1)
    _, sel = jax.lax.top_k(probs, top_k)
    sel = np.asarray(sel)
    n = sel.shape[0]
    m = n * top_k
    cap = max(8, min(int(-(-(n * top_k * cf) // n_experts)), m))
    eid = sel.reshape(m)
    order = np.argsort(eid, kind="stable")
    s_eid, s_tok = eid[order], np.repeat(np.arange(n), top_k)[order]
    counts = np.bincount(s_eid, minlength=n_experts)
    offsets = np.cumsum(counts) - counts
    pos = np.arange(m) - offsets[s_eid]
    buf = np.full((n_experts, cap), -1)
    for e in range(n_experts):
        c = min(counts[e], cap)
        buf[e, :c] = s_tok[offsets[e]: offsets[e] + c]
    return dict(sel=sel, order=order, counts=counts, buf=buf, in_cap=pos < cap, cap=cap)


@pytest.mark.parametrize("cf", [0.5, 1.25, 4.0])
def test_moe_apply(cf):
    """Outputs to 1e-5 and the aux loss; at capacity factor 0.5 copies are
    dropped, and the dispatch (counts, slot tokens, dropped copies) equals
    the reference's routing exactly."""
    jp, tp, x = _moe_case()
    jy, jaux = JM.moe_apply(jp, jnp.asarray(x), top_k=2, n_experts=8, capacity_factor=cf)
    ty, taux = TM.moe_apply(tp, _t(x), top_k=2, n_experts=8, capacity_factor=cf)
    _close(ty, jy, 1e-5)
    _close(taux, jaux, 1e-5)
    want = _reference_dispatch(jp, x, 2, 8, cf)
    r = TM.route(tp["router"]["w"], _t(x).reshape(-1, 16), top_k=2, n_experts=8,
                 capacity_factor=cf)
    assert r.cap == want["cap"]
    np.testing.assert_array_equal(r.experts.numpy(), want["sel"])
    np.testing.assert_array_equal(r.order.numpy(), want["order"])
    np.testing.assert_array_equal(r.counts.numpy(), want["counts"])
    np.testing.assert_array_equal(np.where(r.slot_valid.numpy(), r.buf_tok.numpy(), -1),
                                  want["buf"])
    np.testing.assert_array_equal(r.in_cap.numpy(), want["in_cap"])
    # at 0.5 whole tokens lose every copy, and such a token reads 0; at 4.0
    # (above E / k) nothing is dropped
    gone = np.setdiff1d(np.arange(80), (want["order"] // 2)[want["in_cap"]])
    if cf == 0.5:
        assert len(gone) > 0
    assert want["in_cap"].all() == (cf == 4.0)
    np.testing.assert_array_equal(ty.reshape(80, 16).numpy()[gone], 0.0)


def test_moe_top_k_ties_go_to_the_lower_expert():
    """A zero router gives every expert the same probability: the top-k
    are the lowest experts, as ``lax.top_k`` picks them."""
    jp, tp, x = _moe_case()
    jp = dict(jp, router={"w": jnp.zeros_like(jp["router"]["w"])})
    tp = dict(tp, router={"w": torch.zeros_like(tp["router"]["w"])})
    jy, _ = JM.moe_apply(jp, jnp.asarray(x), top_k=3, n_experts=8)
    ty, _ = TM.moe_apply(tp, _t(x), top_k=3, n_experts=8)
    _close(ty, jy, 1e-5)
    r = TM.route(tp["router"]["w"], _t(x).reshape(-1, 16), top_k=3, n_experts=8)
    assert (r.experts.numpy() == [0, 1, 2]).all()


# ------------------------------------------------------------- transformer ---

def _batch(family, b, t, seed, vocab):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": _t(toks, torch.int64)}
    if family == "vlm":
        pos = np.broadcast_to(np.arange(t, dtype=np.int32), (3, b, t))
        jb["positions"], tb["positions"] = jnp.asarray(pos), _t(pos, torch.int64)
    return jb, tb


# the transformer family's archs; tests/test_torch_lm_families.py holds the others
TRANSFORMER_ARCH_IDS = [a for a in registry.ARCH_IDS
                        if registry.get_config(a).family in ("dense", "moe", "vlm")]


@pytest.mark.parametrize("arch_id", TRANSFORMER_ARCH_IDS)
def test_smoke_model_matches_reference(arch_id):
    """Prefill logits to 1e-4, three greedy decode steps to 2e-3 (the
    bfloat16 cache), the cache's index, and the port's own cache equal to
    the reference's to the same 2e-3."""
    ja, ta = j_get_config(arch_id), registry.get_config(arch_id)
    jm = j_zoo.build(ja.smoke_model, ja.family)
    tm = t_zoo.build(ta.smoke_model, ta.family)
    jp = jm.init(jax.random.PRNGKey(11))
    tp = lm_from_arrays(jax.tree.map(np.asarray, jp), device=CPU)
    jb, tb = _batch(ja.family, 2, 13, 12, ja.smoke_model.vocab)
    jl, jc = jax.jit(lambda p, b: jm.prefill(p, b, 20))(jp, jb)
    tl, tc = tm.prefill(tp, tb, 20)
    _close(tl, jl, 1e-4)
    assert tc.index == int(jc.index) == 13
    assert tc.k.dtype == torch.bfloat16 and tuple(tc.k.shape) == jc.k.shape
    jdec = jax.jit(jm.decode_step)
    for _ in range(3):
        tok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
        jl, jc = jdec(jp, tok, jc)
        tl, tc = tm.decode_step(tp, _t(np.asarray(tok), torch.int64), tc)
        _close(tl, jl, 2e-3)
        assert tc.index == int(jc.index)
    _close(tc.k.float(), jnp.asarray(jc.k, jnp.float32), 2e-3)
    _close(tc.v.float(), jnp.asarray(jc.v, jnp.float32), 2e-3)


# bfloat16 activations, as every full-size config; grok also has bfloat16
# parameters: a dense model, two MoEs and the M-RoPE model
PUBLISHED_DTYPE_ARCHS = ["qwen2-7b", "granite-moe-1b-a400m", "grok-1-314b", "qwen2-vl-7b"]


@pytest.mark.parametrize("arch_id", PUBLISHED_DTYPE_ARCHS)
def test_smoke_model_matches_reference_in_published_dtypes(arch_id):
    """The smoke model in its full-size config's dtypes against the
    reference jitted with ``xla_allow_excess_precision`` off.  XLA's
    default lets a fusion skip the bfloat16 roundings its ops write, so the
    reference's default-jitted logits differ from its op-by-op ones by
    about as much as bfloat16 differs from float32; with the option off,
    it rounds after every op, as its eager run and the port do.  Prefill
    and three greedy decode steps to 1e-6 (readings up to 1.8e-7: the
    float32 unembedding's sums), the bfloat16 KV caches bit for bit."""
    ja, ta = j_get_config(arch_id), registry.get_config(arch_id)
    assert ta.model.act_dtype == torch.bfloat16
    jcfg = dataclasses.replace(ja.smoke_model, act_dtype=ja.model.act_dtype,
                               param_dtype=ja.model.param_dtype)
    tcfg = dataclasses.replace(ta.smoke_model, act_dtype=ta.model.act_dtype,
                               param_dtype=ta.model.param_dtype)
    jm, tm = j_zoo.build(jcfg, ja.family), t_zoo.build(tcfg, ta.family)
    jp = jm.init(jax.random.PRNGKey(11))
    tp = lm_from_arrays(jax.tree.map(np.asarray, jp), device=CPU)
    jb, tb = _batch(ja.family, 2, 13, 12, jcfg.vocab)
    strict = {"xla_allow_excess_precision": False}
    jl, jc = jax.jit(lambda p, b: jm.prefill(p, b, 20), compiler_options=strict)(jp, jb)
    tl, tc = tm.prefill(tp, tb, 20)
    _close(tl, jl, 1e-6)
    jdec = jax.jit(jm.decode_step, compiler_options=strict)
    for _ in range(3):
        tok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
        jl, jc = jdec(jp, tok, jc)
        tl, tc = tm.decode_step(tp, _t(np.asarray(tok), torch.int64), tc)
        _close(tl, jl, 1e-6)
    assert tc.index == int(jc.index) == 16
    for got, want in ((tc.k, jc.k), (tc.v, jc.v)):
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("arch_id", ["qwen3-14b", "granite-moe-1b-a400m", "qwen2-vl-7b"])
def test_decode_consistency(arch_id):
    """``tests/test_models.py``'s rule in the port: prefill of the first 7
    tokens and decode of the next two give ``forward``'s logits at those
    positions, 2e-4 with a float32 cache.  An MoE's capacity depends on the
    tokens of the call, so it is held where nothing is dropped: at
    capacity factor E / k."""
    cfg = dataclasses.replace(registry.get_config(arch_id).smoke_model, q_chunk=4)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    p = TT.init(cfg, torch.Generator().manual_seed(3), device=CPU)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (2, 10)))
    pos = None
    if cfg.mrope_sections is not None:
        pos = torch.arange(10)[None, None].expand(3, 2, 10)
    h, _ = TT.forward(p, cfg, toks, positions=pos)
    full = TL.unembed(p["embed"], h)
    lg, cache = TT.prefill(p, cfg, toks[:, :7], 12,
                           positions=None if pos is None else pos[..., :7],
                           cache_dtype=torch.float32)
    _close(lg, full[:, 6], 2e-4)
    for i in (7, 8):
        lg, cache = TT.decode_step(p, cfg, toks[:, i:i + 1], cache)
        _close(lg, full[:, i], 2e-4)


def test_init_on_the_device_and_the_families():
    cfg = registry.get_config("granite-moe-1b-a400m").smoke_model
    p = TT.init(cfg, torch.Generator().manual_seed(0), device=CPU)
    assert len(p["blocks"]) == cfg.n_layers
    moe = p["blocks"][0]["moe"]
    assert tuple(moe["w_gate"].shape) == (8, 64, 32) and moe["router"]["w"].dtype == torch.float32
    assert torch.equal(p["blocks"][1]["ln1"]["scale"], torch.ones(64))
    q = TT.init(cfg, torch.Generator().manual_seed(0), device=CPU)
    assert torch.equal(p["embed"]["table"], q["embed"]["table"])
    assert 0.015 < float(p["embed"]["table"].std()) < 0.025
    w = p["blocks"][0]["attn"]["wq"]["w"]
    assert abs(float(w.std()) * 64 ** 0.5 - 1.0) < 0.1
    # every family builds, and its smoke model serves a prefill and a step
    for arch_id in ("whisper-tiny", "mamba2-130m", "zamba2-2.7b"):
        arch = registry.get_config(arch_id)
        model = t_zoo.build(arch.smoke_model, arch.family)
        params = model.init(torch.Generator().manual_seed(0), CPU)
        batch = {"tokens": torch.zeros((2, 3), dtype=torch.int64)}
        if arch.family == "encdec":
            batch["frames"] = torch.zeros((2, 3, arch.smoke_model.d_model))
        logits, cache = model.prefill(params, batch, 5)
        logits, cache = model.decode_step(params, logits.argmax(-1)[:, None], cache)
        assert tuple(logits.shape) == (2, arch.smoke_model.vocab) and cache.index == 4
        assert bool(torch.isfinite(logits).all())
    with pytest.raises(ValueError):
        t_zoo.build(cfg, "rnn")


# ----------------------------------------------------------------- configs ---

def _mapped(v):
    """A reference config value with jnp dtypes and configs mapped to the
    port's."""
    if v is jnp.float32 or v is jnp.bfloat16:
        return {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[v]
    return v


def _fields_equal(got, want, where):
    gf = {f.name for f in dataclasses.fields(got)}
    wf = {f.name for f in dataclasses.fields(want)}
    assert gf <= wf, f"{where}: fields the reference lacks {gf - wf}"
    if isinstance(want, JT.TransformerConfig):
        assert wf - gf == {"act_sharding", "attn_impl"}
        assert want.act_sharding is None and want.moe_impl == got.moe_impl == "gspmd"
        assert want.attn_impl == "flash"
    elif isinstance(want, JE.EncDecConfig):
        assert wf - gf == {"attn_impl"} and want.attn_impl == "flash"
    else:
        assert gf == wf, where
    for name in sorted(gf):
        g, w = getattr(got, name), getattr(want, name)
        if dataclasses.is_dataclass(w):
            _fields_equal(g, w, f"{where}.{name}")
        else:
            assert g == _mapped(w), f"{where}.{name}: {g!r} != {w!r}"


@pytest.mark.parametrize("arch_id", registry.ARCH_IDS)
def test_config_fields_equal_reference(arch_id):
    got, want = registry.get_config(arch_id), j_get_config(arch_id)
    _fields_equal(got, want, arch_id)
    assert [c.name for c in got.runnable_cells()] == [c.name for c in want.runnable_cells()]
    assert got.skipped_cells() == want.skipped_cells()
    for shape in SHAPES:
        assert got.microbatch(shape) == want.microbatch(shape)
    if hasattr(want.model, "hd"):
        assert got.model.hd == want.model.hd and got.smoke_model.hd == want.smoke_model.hd
    if hasattr(want.model, "mamba_config"):
        for g, w in ((got.model, want.model), (got.smoke_model, want.smoke_model)):
            _fields_equal(g.mamba_config(), w.mamba_config(), f"{arch_id}.mamba_config")
            assert g.mamba_config().n_heads == w.mamba_config().n_heads


def test_registry_and_shapes():
    from repro.configs import base as jbase
    from repro.configs.registry import ARCH_IDS as J_IDS

    assert registry.ARCH_IDS == J_IDS
    # every family is ported: each arch resolves to its own config
    assert [(registry.get_config(a).arch_id, registry.get_config(a).family) for a in J_IDS] == \
        [(a, j_get_config(a).family) for a in J_IDS]
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jbase.SHAPES.items()}
    assert pad_to_multiple(49155, 16) == jbase.pad_to_multiple(49155, 16) == 49168
    with pytest.raises(KeyError):
        registry.get_config("gpt-5")
    assert list(registry.all_configs()) == registry.ARCH_IDS
