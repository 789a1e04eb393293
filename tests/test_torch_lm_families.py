"""The port's ssm, hybrid and encdec families (``repro_torch.models``:
``mamba2``, ``ssm_lm``, ``hybrid``, ``encdec``; the mamba2-130m,
zamba2-2.7b and whisper-tiny configs; ``Server`` over them) against the
JAX package on the CPU.

The same inputs, made from a seed with numpy, go through ``repro.models``
(jitted) and the port, with the reference's parameters carried across by
``convert.lm_from_arrays``.  Tolerances:

- the layer functions (``_conv1d``, ``_ssd_chunked``, ``mamba2_forward``,
  ``mamba2_prefill_state``, ``mamba2_decode_step``, cross-attention, the
  LayerNorm and the non-gated MLP): 2e-5, as ``tests/test_torch_models.py``
  holds the transformer's layers;
- each smoke config through ``model_zoo``: prefill logits 1e-4; three
  greedy decode steps 1e-4 (ssm: float32 state) or 2e-3 (hybrid, encdec:
  the bfloat16 KV caches); the ssm state after prefill 1e-5; the cache
  index exactly;
- whisper with the ``Server``'s bfloat16 frames against the reference
  jitted without excess precision: see
  ``test_whisper_bfloat16_frames_match_strict_reference``;
- the decode-consistency rule of ``tests/test_models.py`` (ssm 5e-4,
  hybrid 1e-3, encdec 2e-4, float32 caches), in the port alone.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.models import encdec as JE
from repro.models import layers as JL
from repro.models import mamba2 as JM
from repro.models import model_zoo as j_zoo
from repro_torch.configs import registry
from repro_torch.convert import lm_from_arrays
from repro_torch.launch import serve
from repro_torch.models import encdec as TE
from repro_torch.models import hybrid as TH
from repro_torch.models import layers as TL
from repro_torch.models import mamba2 as TM
from repro_torch.models import model_zoo as t_zoo
from repro_torch.models import ssm_lm as TS

CPU = "cpu"
LAYER_TOL = 2e-5
FAMILY_ARCHS = ["mamba2-130m", "zamba2-2.7b", "whisper-tiny"]
STRICT = {"xla_allow_excess_precision": False}


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


def _carry(tree):
    return lm_from_arrays(jax.tree.map(np.asarray, tree), device=CPU)


# ------------------------------------------------------------------ mamba2 ---

def _mamba_case(n_groups: int, t: int):
    jcfg = JM.Mamba2Config(d_model=32, d_state=8, head_dim=16, n_groups=n_groups, chunk=16)
    tcfg = TM.Mamba2Config(**dataclasses.asdict(jcfg))
    jp = JM.mamba2_init(jax.random.PRNGKey(n_groups), jcfg)
    # non-zero conv bias and D, so their terms are held too
    rng = np.random.default_rng(t * 10 + n_groups)
    jp = dict(jp, conv_b=jnp.asarray(rng.standard_normal(jcfg.conv_dim), jnp.float32) * 0.1,
              D=jnp.asarray(rng.random(jcfg.n_heads) + 0.5, jnp.float32))
    u = rng.standard_normal((2, t, 32)).astype(np.float32)
    return jcfg, tcfg, jp, _carry(jp), u, rng


@pytest.mark.parametrize("t", [2, 16, 37])
@pytest.mark.parametrize("n_groups", [1, 2])
def test_mamba2_layers(n_groups, t):
    """Every Mamba2 function at one chunk (16), three chunks with padding
    (37 at Q = 16) and a prompt shorter than the conv window (2), with one
    and two B/C groups (``repeat_interleave``, not ``repeat``)."""
    jcfg, tcfg, jp, tp, u, rng = _mamba_case(n_groups, t)
    ju, tu = jnp.asarray(u), _t(u)
    # the conv and the SSD on the block's own intermediate values
    zx = u @ np.asarray(jp["in_proj"]["w"])
    _, xbc, dt = TM._split_proj(tcfg, _t(zx))
    _close(TM._conv1d(xbc, tp["conv_w"], tp["conv_b"]),
           jax.jit(JM._conv1d)(jnp.asarray(xbc.numpy()), jp["conv_w"], jp["conv_b"]), LAYER_TOL)
    h, g, n = jcfg.n_heads, n_groups, jcfg.d_state
    x = rng.standard_normal((2, t, h, 16)).astype(np.float32)
    b_, c_ = (rng.standard_normal((2, t, g, n)).astype(np.float32) for _ in range(2))
    dtv = np.log1p(np.exp(rng.standard_normal((2, t, h)))).astype(np.float32)
    want = jax.jit(JM._ssd_chunked, static_argnums=5)(*map(jnp.asarray, (x, b_, c_, dtv)),
                                                      jp["A_log"], 16)
    _close(TM._ssd_chunked(*map(_t, (x, b_, c_, dtv)), tp["A_log"], 16), want, LAYER_TOL)
    # the block
    _close(TM.mamba2_forward(tp, tcfg, tu),
           jax.jit(JM.mamba2_forward, static_argnums=1)(jp, jcfg, ju), LAYER_TOL)
    st = TM.mamba2_prefill_state(tp, tcfg, tu)
    jst = jax.jit(JM.mamba2_prefill_state, static_argnums=1)(jp, jcfg, ju)
    _close(st.ssm, jst.ssm, LAYER_TOL)
    assert tuple(st.conv.shape) == (2, 3, tcfg.conv_dim)
    if t >= jcfg.conv_width - 1:
        _close(st.conv, jst.conv, LAYER_TOL)
    else:
        # the reference's window ``xbc[:, t - 3:]`` starts below 0 here and
        # keeps one row, [B, 2, C]; the port's holds the last min(t, 3)
        # inputs after zeros: the reference's last row and the raw input
        raw = _t(zx)[..., tcfg.d_inner:tcfg.d_inner + tcfg.conv_dim]
        assert jst.conv.shape == (2, 2, tcfg.conv_dim)
        _close(st.conv[:, -1], jst.conv[:, -1], LAYER_TOL)
        _close(st.conv[:, 3 - t:], raw, LAYER_TOL)
        assert not st.conv[:, :3 - t].any()
    # one decode step from the same state (the port's, which every T has)
    step = jax.jit(JM.mamba2_decode_step, static_argnums=1)
    u1 = rng.standard_normal((2, 1, 32)).astype(np.float32)
    jy, jnew = step(jp, jcfg, jnp.asarray(u1),
                    JM.Mamba2State(conv=jnp.asarray(st.conv.numpy()), ssm=jnp.asarray(st.ssm.numpy())))
    ty, tnew = TM.mamba2_decode_step(tp, tcfg, _t(u1), st)
    _close(ty, jy, LAYER_TOL)
    _close(tnew.conv, jnew.conv, LAYER_TOL)
    _close(tnew.ssm, jnew.ssm, LAYER_TOL)


@pytest.mark.parametrize("t", [2, 37])
def test_mamba2_prefill_then_decode_equals_forward(t):
    """``tests/test_models.py``'s recurrent-decode rule in the port: the
    state after ``t`` tokens, then four decode steps, give the forward's
    outputs at those positions (2e-4), a 2-token prompt included."""
    _, tcfg, _, tp, u, rng = _mamba_case(2, t + 4)
    tu = _t(u)
    full = TM.mamba2_forward(tp, tcfg, tu)
    state = TM.mamba2_prefill_state(tp, tcfg, tu[:, :t])
    for i in range(t, t + 4):
        y, state = TM.mamba2_decode_step(tp, tcfg, tu[:, i:i + 1], state)
        _close(y[:, 0], full[:, i], 2e-4)


def test_softplus_is_jax_logaddexp():
    x = np.concatenate([np.linspace(-40, 40, 4001), [-1e4, 1e4, 0.0]]).astype(np.float32)
    _close(TM.softplus(_t(x)), jax.jit(jax.nn.softplus)(jnp.asarray(x)), 1e-6)


# ------------------------------------------ cross-attention, norms, GELU ---

def test_cross_attention_layernorm_and_plain_mlp():
    """Cross-attention (unmasked, the memory's k/v, also bfloat16 memory
    under float32 queries as whisper's decoder reads it), ``layernorm_init``
    and the non-gated GELU MLP in float32."""
    jcfg = JL.AttnConfig(d_model=24, n_heads=3, n_kv_heads=3, head_dim=8, qkv_bias=True,
                         rope_theta=0.0, causal=True, q_chunk=4, k_chunk=4)
    tcfg = TL.AttnConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k != "attn_impl"})
    jp = JL.attn_init(jax.random.PRNGKey(1), jcfg)
    jp = jax.tree.map(lambda a: a + 0.1, jp)       # non-zero biases
    tp = TL.tree_map(lambda a: _t(a), jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    pos = np.broadcast_to(np.arange(5), (2, 5))
    for dt in (jnp.float32, jnp.bfloat16):
        k = rng.standard_normal((2, 7, 3, 8)).astype(np.float32)
        v = rng.standard_normal((2, 7, 3, 8)).astype(np.float32)
        jk, jv = jnp.asarray(k, dt), jnp.asarray(v, dt)
        tk, tv = (_t(np.asarray(a.astype(jnp.float32))).to(
            torch.bfloat16 if dt == jnp.bfloat16 else torch.float32) for a in (jk, jv))
        want = jax.jit(lambda p, a, kk, vv: JL.attention(p, jcfg, a, jnp.asarray(pos), kv=(kk, vv)))(
            jp, jnp.asarray(x), jk, jv)
        _close(TL.attention(tp, tcfg, _t(x), _t(pos), kv=(tk, tv)), want, LAYER_TOL)
    ln = TL.layernorm_init(24)
    jln = JL.layernorm_init(24)
    assert all(torch.equal(ln[k], _t(jln[k])) for k in ("scale", "bias"))
    jm = JL.mlp_init(jax.random.PRNGKey(3), 24, 40, gated=False)
    tm = TL.tree_map(lambda a: _t(a), jax.tree.map(np.asarray, jm))
    xs = rng.standard_normal((2, 5, 24)).astype(np.float32) * 3
    _close(TL.mlp(tm, _t(xs)), jax.jit(JL.mlp)(jm, jnp.asarray(xs)), LAYER_TOL)


def test_gelu_rounds_as_xla_in_bfloat16():
    """``layers.gelu`` against XLA's ``jax.nn.gelu`` (compiled without
    excess precision) over every finite bfloat16 in [-20, 20]: bit for bit
    wherever XLA's result is normal (XLA flushes subnormals to zero).
    ``F.gelu(approximate="tanh")`` rounds once and is an ulp off on 4.5%."""
    bits = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16)
    xb = bits.view(torch.bfloat16)
    xb = xb[torch.isfinite(xb.float()) & (xb.float().abs() <= 20)]
    want = np.asarray(jax.jit(jax.nn.gelu, compiler_options=STRICT)(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)).astype(jnp.float32))
    got = TL.gelu(xb).float().numpy()
    normal = np.abs(want) >= np.float32(2.0 ** -126)
    assert normal.sum() > 30_000
    np.testing.assert_array_equal(got[normal], want[normal])
    assert np.abs(got[~normal]).max() <= 2.0 ** -126


# ------------------------------------------------------- the three models ---

@pytest.fixture(scope="module")
def reference():
    """Each family's reference smoke model, parameters and jitted prefill /
    decode, made once and shared by the tests below (the jit caches key on
    the functions)."""
    out = {}
    for arch_id in FAMILY_ARCHS:
        ja = j_get_config(arch_id)
        jm = j_zoo.build(ja.smoke_model, ja.family)
        jp = jm.init(jax.random.PRNGKey(11))
        out[arch_id] = dict(arch=ja, model=jm, params=jp,
                            prefill=jax.jit(jm.prefill, static_argnums=2),
                            decode=jax.jit(jm.decode_step))
    return out


def _batch(family, b, t, seed, vocab, d_model):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, t)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": _t(toks, torch.int64)}
    if family == "encdec":
        fr = rng.standard_normal((b, t, d_model)).astype(np.float32)
        jb["frames"], tb["frames"] = jnp.asarray(fr), _t(fr)
    return jb, tb


@pytest.mark.parametrize("arch_id", FAMILY_ARCHS)
def test_smoke_model_matches_reference(arch_id, reference):
    """Prefill logits to 1e-4 over a 37-token prompt (three SSD chunks of
    16 with padding), three greedy decode steps to 1e-4 (ssm) or 2e-3 (the
    bfloat16 KV caches), the ssm state after prefill to 1e-5, the index."""
    ref = reference[arch_id]
    ja, jm, jp = ref["arch"], ref["model"], ref["params"]
    ta = registry.get_config(arch_id)
    tm = t_zoo.build(ta.smoke_model, ta.family)
    tp = _carry(jp)
    jb, tb = _batch(ja.family, 2, 37, 12, ja.smoke_model.vocab, ja.smoke_model.d_model)
    jl, jc = ref["prefill"](jp, jb, 48)
    tl, tc = tm.prefill(tp, tb, 48)
    _close(tl, jl, 1e-4)
    assert tc.index == int(jc.index) == 37
    if ja.family in ("ssm", "hybrid"):
        _close(tc.ssm, jc.ssm, 1e-5)
        _close(tc.conv, jc.conv, 1e-5)
    if ja.family in ("hybrid", "encdec"):
        assert tc.k.dtype == torch.bfloat16 and tuple(tc.k.shape) == jc.k.shape
    tol = 1e-4 if ja.family == "ssm" else 2e-3
    for _ in range(3):
        tok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
        jl, jc = ref["decode"](jp, tok, jc)
        tl, tc = tm.decode_step(tp, _t(np.asarray(tok), torch.int64), tc)
        _close(tl, jl, tol)
        assert tc.index == int(jc.index)
    for name in ("conv", "ssm"):                 # float32
        if ja.family != "encdec":
            _close(getattr(tc, name), getattr(jc, name), tol)
    for name in ("k", "v", "cross_k", "cross_v"):
        if hasattr(tc, name):
            # bfloat16: a float32 ulp apart can round to the next bfloat16,
            # 2^-7 of the larger magnitude at most
            np.testing.assert_allclose(getattr(tc, name).float().numpy(),
                                       np.asarray(getattr(jc, name), np.float32),
                                       rtol=2.0 ** -7, atol=tol, err_msg=name)


def test_whisper_bfloat16_frames_match_strict_reference(reference):
    """whisper's smoke model on the ``Server``'s bfloat16 frames (the
    encoder in bfloat16, the float32 decoder reading bfloat16 memory)
    against the reference jitted without excess precision.  Not bit for
    bit: the bfloat16 products of the MLP's down projection are summed in
    float32 in another order than XLA's dot, so some of its outputs land
    one bfloat16 ulp apart, and the attention spreads each such ulp
    (``test_whisper_bfloat16_ops_match_strict_reference`` feeds each op of
    the first encoder block the reference's own input and finds every
    other op bit-identical there).  Readings (seed 11, 2 x 13 tokens):
    prefill and decode logits 4.2e-4 to 5.2e-4 off (RMS 0.133; the
    default-jitted reference 1.25e-3 to 1.40e-3), 23-25% of the cross
    caches' entries and 4.5-5.1% of the self caches' differ, each cache by
    at most 0.0078-0.0156 at an RMS of 0.94-1.07.  Held at: logits within
    8e-4 (between the reading and the default-jitted reference's), each
    cache's largest error within 0.05 of its RMS (read 0.0081-0.0166).
    """
    ref = reference["whisper-tiny"]
    jm, jp = ref["model"], ref["params"]
    server = serve.Server("whisper-tiny", max_len=20, device=CPU)
    server.params = _carry(jp)
    toks = np.random.default_rng(12).integers(0, 256, (2, 13)).astype(np.int32)
    tb = server.make_batch(toks)
    jb = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(
        np.random.default_rng(0).standard_normal((2, 13, 48)), dtype=jnp.bfloat16)}
    np.testing.assert_array_equal(tb["frames"].float().numpy(), np.asarray(jb["frames"], np.float32))
    jl, jc = jax.jit(jm.prefill, static_argnums=2, compiler_options=STRICT)(jp, jb, 20)
    tl, tc = server.model.prefill(server.params, tb, 20)
    _close(tl, jl, 8e-4)
    jdec = jax.jit(jm.decode_step, compiler_options=STRICT)
    for _ in range(3):
        tok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
        jl, jc = jdec(jp, tok, jc)
        tl, tc = server.model.decode_step(server.params, _t(np.asarray(tok), torch.int64), tc)
        _close(tl, jl, 8e-4)
    for name in ("k", "v", "cross_k", "cross_v"):
        assert getattr(tc, name).dtype == torch.bfloat16
        got = getattr(tc, name).float().numpy()
        want = np.asarray(getattr(jc, name), np.float32)
        rms = float(np.sqrt(np.mean(want[want != 0] ** 2)))
        assert np.abs(got - want).max() <= 0.05 * rms, name


def test_whisper_bfloat16_ops_match_strict_reference(reference):
    """Where the bfloat16 encoder parts from the strict reference: each op
    of whisper's first encoder block, fed the reference's own bfloat16
    input, against that op jitted without excess precision.  On these
    inputs the positions' sum, LayerNorm (also at a drawn scale and bias),
    attention, the up projection and GELU are bit-identical; the down
    projection sums its 96 bfloat16 products in float32 in another order
    than XLA's dot, and 0.08% of its outputs (seed 11) are one bfloat16
    ulp off, held at one ulp (2^-7 of the magnitude) on at most 1%.
    (LayerNorm is not bit-identical everywhere: over 4,096 rows of
    standard normal bfloat16 inputs of width 48, 2e-5 of its outputs are
    an ulp off, its float32 sums rounding in another order than XLA's.)"""
    ref = reference["whisper-tiny"]
    jcfg = ref["arch"].smoke_model
    tcfg = registry.get_config("whisper-tiny").smoke_model
    jblk = jax.tree.map(lambda a: a[0], ref["params"]["enc_blocks"])
    tblk = _carry(ref["params"])["enc_blocks"][0]
    b, t, d = 2, 13, jcfg.d_model

    def strict(f, *args):
        return jax.jit(f, compiler_options=STRICT)(*args)

    def bf(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)

    def same(got, want, name):
        assert got.dtype == torch.bfloat16, name
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32),
                                      err_msg=name)

    frames = jnp.asarray(np.random.default_rng(0).standard_normal((b, t, d)), dtype=jnp.bfloat16)
    x = strict(lambda f: f + JE.sinusoidal(t, d).astype(f.dtype), frames)
    same(bf(frames) + TE.sinusoidal(t, d, CPU).to(torch.bfloat16), x, "positions")
    rng = np.random.default_rng(11)
    drawn = {k: rng.normal(m, 0.3, d).astype(np.float32) for k, m in (("scale", 1.0), ("bias", 0.0))}
    for name, p in (("ln1", jblk["ln1"]), ("drawn", drawn)):
        h = strict(lambda p, x: JL.layernorm(p, x, jcfg.norm_eps), p, x)
        same(TL.layernorm({k: _t(v) for k, v in p.items()}, bf(x), tcfg.norm_eps), h,
             f"layernorm {name}")
    h = strict(lambda p, x: JL.layernorm(p, x, jcfg.norm_eps), jblk["ln1"], x)
    pos = np.broadcast_to(np.arange(t)[None], (b, t)).copy()
    a = strict(lambda p, x: JL.attention(p, jcfg.attn_config(False), x, jnp.asarray(pos)),
               jblk["attn"], h)
    same(TL.attention(tblk["attn"], tcfg.attn_config(False), bf(h), torch.as_tensor(pos)), a,
         "attention")
    h2 = strict(lambda p, x, a: JL.layernorm(p, x + a, jcfg.norm_eps), jblk["ln2"], x, a)
    up = strict(JL.dense, jblk["mlp"]["w_up"], h2)
    same(TL.dense(tblk["mlp"]["w_up"], bf(h2)), up, "up projection")
    g = strict(jax.nn.gelu, up)
    same(TL.gelu(bf(up)), g, "gelu")
    down = np.asarray(strict(JL.dense, jblk["mlp"]["w_down"], g), np.float32)
    got = TL.dense(tblk["mlp"]["w_down"], bf(g)).float().numpy()
    err = np.abs(got - down)
    assert np.all(err <= 2.0 ** -7 * np.abs(down)), "down projection: more than one ulp"
    assert np.mean(err > 0) <= 0.01, f"down projection: {np.mean(err > 0)} of outputs differ"


def _reference_generate(ref, prompts, frames, max_new: int, max_len: int):
    """``repro.launch.serve.Server.generate``'s greedy loop, without its
    mesh, over the shared jitted prefill and decode."""
    batch = {"tokens": jnp.asarray(prompts)}
    if frames is not None:
        batch["frames"] = frames
    logits, cache = ref["prefill"](ref["params"], batch, max_len)
    out = np.zeros((prompts.shape[0], max_new), np.int32)
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    for i in range(max_new):
        out[:, i] = np.asarray(tok)[:, 0]
        logits, cache = ref["decode"](ref["params"], tok, cache)
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    return out


@pytest.mark.parametrize("arch_id", FAMILY_ARCHS)
def test_server_greedy_tokens_equal_reference_loop(arch_id, reference):
    """``Server.generate`` of the smoke model against the reference's loop
    over its jitted ``model_zoo`` on the same prompts (and, for whisper,
    the reference ``Server``'s bfloat16 frames, the reference compiled as
    ``Server`` compiles it): the same greedy tokens."""
    ref = reference[arch_id]
    b, t, new = 3, 11, 8
    prompts = np.random.default_rng(5).integers(0, 256, (b, t)).astype(np.int32)
    server = serve.Server(arch_id, max_len=t + new, device=CPU)
    server.params = _carry(ref["params"])
    frames = None
    if ref["arch"].family == "encdec":
        frames = jnp.asarray(np.random.default_rng(0).standard_normal((b, t, server.d_model)),
                             dtype=jnp.bfloat16)
    toks, stats = server.generate(prompts, new)
    np.testing.assert_array_equal(toks, _reference_generate(ref, prompts, frames, new, t + new))
    assert stats["decode_tok_per_s"] == pytest.approx(b * new / stats["decode_s"])


def test_stub_frames_equal_the_reference_servers():
    """``make_batch``'s frames at whisper-tiny's width, bit for bit as the
    reference's ``jnp.asarray(..., dtype=jnp.bfloat16)`` makes them: float64
    rounded through float32 (the rounding that matches; a float64 just past
    a bfloat16 tie shows the difference)."""
    got = serve.stub_frames(8, 64, 384, CPU)
    want = jnp.asarray(np.random.default_rng(0).standard_normal((8, 64, 384)), dtype=jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))
    tie = np.array([1 + 2.0 ** -8 + 2.0 ** -40])
    via32 = torch.from_numpy(tie.astype(np.float32)).to(torch.bfloat16).double().numpy()
    np.testing.assert_array_equal(via32, np.asarray(jnp.asarray(tie, dtype=jnp.bfloat16),
                                                    np.float64))
    assert via32[0] == 1.0     # the direct rounding: 1 + 2^-7


def test_ssm_generates_past_max_len_kv_families_raise():
    """The ssm family keeps no KV cache, so a generate past ``max_len``
    serves; a family with one raises, as the transformer does."""
    prompts = np.arange(12, dtype=np.int32).reshape(2, 6)
    toks, _ = serve.Server("mamba2-130m", max_len=8, device=CPU).generate(prompts, 10)
    assert toks.shape == (2, 10) and ((toks >= 0) & (toks < 256)).all()
    for arch_id in ("zamba2-2.7b", "whisper-tiny"):
        with pytest.raises(IndexError):
            serve.Server(arch_id, max_len=8, device=CPU).generate(prompts, 10)


# ------------------------------------------------------ decode consistency ---

def test_decode_consistency_ssm():
    cfg = TS.SSMConfig(name="s", n_layers=2, d_model=32, vocab=40, d_state=16, head_dim=16,
                       chunk=4, remat=False)
    p = TS.init(cfg, torch.Generator().manual_seed(3), device=CPU)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 40, (2, 9)))
    full = TL.unembed(p["embed"], TS.forward(p, cfg, toks))
    lg, cache = TS.prefill(p, cfg, toks[:, :6], 9)
    _close(lg, full[:, 5], 5e-4)
    for i in (6, 7):
        lg, cache = TS.decode_step(p, cfg, toks[:, i:i + 1], cache)
        _close(lg, full[:, i], 5e-4)


def test_decode_consistency_hybrid():
    cfg = TH.HybridConfig(name="h", n_layers=4, d_model=32, n_heads=4, n_kv_heads=4, d_ff=64,
                          vocab=40, attn_every=2, d_state=16, ssm_head_dim=16, chunk=4,
                          q_chunk=4, remat=False)
    p = TH.init(cfg, torch.Generator().manual_seed(3), device=CPU)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 40, (2, 8)))
    full = TL.unembed(p["embed"], TH.forward(p, cfg, toks))
    lg, cache = TH.prefill(p, cfg, toks[:, :5], 10, cache_dtype=torch.float32)
    _close(lg, full[:, 4], 1e-3)
    for i in (5, 6):
        lg, cache = TH.decode_step(p, cfg, toks[:, i:i + 1], cache)
        _close(lg, full[:, i], 1e-3)


def test_decode_consistency_encdec():
    cfg = TE.EncDecConfig(name="w", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
                          vocab=40, q_chunk=4, remat=False)
    p = TE.init(cfg, torch.Generator().manual_seed(3), device=CPU)
    rng = np.random.default_rng(3)
    frames = _t(rng.standard_normal((2, 6, 32)).astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, 40, (2, 8)))
    full = TL.unembed(p["embed"], TE.decode_train(p, cfg, toks, TE.encode(p, cfg, frames)))
    lg, cache = TE.prefill(p, cfg, frames, toks[:, :5], 10, cache_dtype=torch.float32)
    _close(lg, full[:, 4], 2e-4)
    for i in (5, 6):
        lg, cache = TE.decode_step(p, cfg, toks[:, i:i + 1], cache)
        _close(lg, full[:, i], 2e-4)


@pytest.mark.parametrize("arch_id", ["qwen2-7b", "granite-moe-1b-a400m", "qwen2-vl-7b",
                                     *FAMILY_ARCHS])
def test_model_forward_last_position_is_prefill(arch_id):
    """``model_zoo.Model.forward`` of each family (encdec: ``encode`` of the
    frames, then ``decode_train``) gives at the prompt's last position
    the logits its prefill gives, on the ``Server``'s batch (whisper's
    bfloat16 frames; qwen2-vl's M-RoPE positions)."""
    server = serve.Server(arch_id, max_len=16, device=CPU)
    toks = np.random.default_rng(5).integers(0, server.vocab, (2, 11)).astype(np.int32)
    batch = server.make_batch(toks)
    hidden = server.model.forward(server.params, batch)
    assert tuple(hidden.shape) == (2, 11, server.d_model)
    logits, _ = server.model.prefill(server.params, batch, 16)
    _close(TL.unembed(server.params["embed"], hidden)[:, -1], logits, 1e-5)


def test_sinusoidal_and_encode_decode_train_match_reference():
    cfg = registry.get_config("whisper-tiny").smoke_model
    jcfg = j_get_config("whisper-tiny").smoke_model
    _close(TE.sinusoidal(13, 48), JE.sinusoidal(13, 48), 1e-6)
    jp = JE.init(jax.random.PRNGKey(4), jcfg)
    tp = _carry(jp)
    rng = np.random.default_rng(4)
    fr = rng.standard_normal((2, 9, 48)).astype(np.float32)
    toks = rng.integers(0, 256, (2, 7)).astype(np.int32)
    jmem = jax.jit(lambda p, f: JE.encode(p, jcfg, f))(jp, jnp.asarray(fr))
    tmem = TE.encode(tp, cfg, _t(fr))
    _close(tmem, jmem, 1e-5)
    _close(TE.decode_train(tp, cfg, _t(toks, torch.int64), tmem),
           jax.jit(lambda p, t, m: JE.decode_train(p, jcfg, t, m))(jp, jnp.asarray(toks), jmem),
           1e-5)


# -------------------------------------------------------------------- init ---

def _shapes(tree, path=""):
    """Every leaf's (path, shape, dtype), sorted by path."""
    if isinstance(tree, dict):
        return sorted(x for k, v in tree.items() for x in _shapes(v, f"{path}/{k}"))
    if isinstance(tree, list):
        return sorted(x for i, v in enumerate(tree) for x in _shapes(v, f"{path}/{i}"))
    return [(path, tuple(tree.shape), tree.dtype)]


@pytest.mark.parametrize("arch_id", FAMILY_ARCHS)
def test_init_shapes_and_distributions(arch_id, reference):
    """The port's init has the reference tree's shapes and dtypes; the
    Mamba2 draws: A_log in [log 1, log 16], softplus(dt_bias) in [1e-3,
    1e-1] and log-uniform there, D 1, conv bias 0; each weight's standard
    deviation times sqrt(fan_in) about 1, the embedding's about 0.02."""
    ta = registry.get_config(arch_id)
    p = t_zoo.build(ta.smoke_model, ta.family).init(torch.Generator().manual_seed(0), CPU)
    want = _carry(reference[arch_id]["params"])
    assert _shapes(p) == _shapes(want)
    assert 0.015 < float(p["embed"]["table"].std()) < 0.025
    blocks = p.get("blocks") or p["dec_blocks"]
    if "mamba" in blocks[0]:
        m = [blk["mamba"] for blk in blocks]
        a_log = torch.cat([b["A_log"] for b in m])
        assert float(a_log.min()) >= 0.0 and float(a_log.max()) <= np.log(16.0) + 1e-6
        dt = torch.log(TM.softplus(torch.cat([b["dt_bias"] for b in m])))
        assert float(dt.min()) >= np.log(1e-3) - 1e-4 and float(dt.max()) <= np.log(1e-1) + 1e-4
        assert all(torch.equal(b["D"], torch.ones_like(b["D"])) and not b["conv_b"].any()
                   for b in m)
        w = m[0]["in_proj"]["w"]
        assert abs(float(w.std()) * w.shape[0] ** 0.5 - 1.0) < 0.1
        cw = m[0]["conv_w"]
        assert abs(float(cw.std()) * cw.shape[0] ** 0.5 - 1.0) < 0.1
    if ta.family == "ssm":
        # dt log-uniform: its mean and spread over 64 layers of 8 heads
        big = TS.init(dataclasses.replace(ta.smoke_model, n_layers=64),
                      torch.Generator().manual_seed(0), device=CPU)
        dt = torch.log(TM.softplus(torch.cat([b["mamba"]["dt_bias"] for b in big["blocks"]])))
        assert abs(float(dt.mean()) - np.log(1e-2)) < 0.15
        assert abs(float(dt.std()) - np.log(100) / 12 ** 0.5) < 0.15
    if ta.family == "encdec":
        blk = p["dec_blocks"][0]
        assert not blk["cross"]["wq"]["b"].any() and not blk["ln3"]["bias"].any()
        w = blk["mlp"]["w_up"]["w"]
        assert abs(float(w.std()) * w.shape[0] ** 0.5 - 1.0) < 0.15
