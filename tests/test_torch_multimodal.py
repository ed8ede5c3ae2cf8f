"""The encoder-decoder and VLM families (Whisper-tiny, LLaVA-NeXT-34B) in
the port against the reference, on the reduced configurations, weights
built by ``repro.models.init_params`` and carried over by ``convert``:

* the registry's fields and parameter counts, and the parameter tree;
* the pieces: the GELU MLP, the encoder, cross-attention at prefill (the
  plain masked attention) and at decode (``ops.flash_decode``);
* Whisper's batch entry points (``prefill(audio_embeds=...)`` and
  ``decode_step`` on dense rows) and LLaVA's (``prefill`` /
  ``prefill_paged`` with ``image_embeds``, then decode steps), teacher
  forced with the reference's greedy tokens: logits within ``LOGIT_TOL``
  and each greedy token the reference's unless the reference's own top-2
  margin there is below ``4 * LOGIT_TOL`` (the engine suite's margin
  rule);
* LLaVA's token-only requests through both engines on both KV layouts;
* Whisper refused wherever the reference refuses it (the engine, the
  paged entry points, the launcher).

Inputs (frames, patches, tokens) are drawn with numpy from a seed and fed
to both packages."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.models import layers as JL
from repro.models import mlp as JM
from repro.models import model as jmodel
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import InferenceEngine as JInferenceEngine
from repro.serving import make_backend as jmake_backend
from repro.serving.requests import make_prompts
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import params_from_reference, to_torch
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import mlp as M
from repro_torch.models import model as tmodel
from repro_torch.models.frontend import (audio_frame_embeddings,
                                         image_patch_embeddings)
from repro_torch.serving.backends import make_backend
from repro_torch.serving.engine import EngineConfig, InferenceEngine
from test_torch_engine import _serve_lockstep
from torch_threads import _one_thread  # noqa: F401

ARCHS = ("whisper-tiny", "llava-next-34b")
#: Logits of the two packages on these two-layer stacks agree to this (bf16
#: projections and logits rounded in each library's order; the families
#: suite's bound).
LOGIT_TOL = 0.05
#: A bf16 block's output (the GELU MLP, the encoder, cross-attention)
#: against the reference's: within 2^-6 of the output's largest magnitude
#: (a few bf16 roundings in another order).
BLOCK_TOL = 2.0 ** -6
NEW_TOKENS = 8
_WEIGHTS = {}


def _weights(arch):
    """(reference config, port config, reference params as numpy), built
    once per module and family."""
    if arch not in _WEIGHTS:
        jcfg = jget_config(arch, reduced=True)
        jp = jinit_params(jax.random.PRNGKey(0), jcfg)
        _WEIGHTS[arch] = (jcfg, get_config(arch, reduced=True),
                          jax.tree_util.tree_map(np.asarray, jp))
    return _WEIGHTS[arch]


def _bf16(rng, shape, scale=1.0):
    """A numpy-seeded bf16 array, as numpy (for JAX) and tensor (port)."""
    a = (rng.standard_normal(shape) * scale).astype(jnp.bfloat16)
    return a, to_torch(a)


def _close(got, want, tol):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (err, tol)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_registry_fields_and_param_count(arch, reduced):
    """The port's configuration has the reference's fields (the new
    ``is_encoder_decoder``, ``n_encoder_layers``, ``encoder_seq`` and
    ``num_image_tokens`` among them, and their reduction rule) and the
    reference's parameter count (the encoder MLP priced at 3·d·d_ff, the
    reference's count)."""
    want, got = jget_config(arch, reduced=reduced), \
        get_config(arch, reduced=reduced)
    assert {f.name for f in dataclasses.fields(got)} == \
        {f.name for f in dataclasses.fields(want)}
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), getattr(want, f.name)
        assert (dataclasses.asdict(g) if dataclasses.is_dataclass(g) else g) \
            == (dataclasses.asdict(w) if dataclasses.is_dataclass(w)
                else w), f.name
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    assert arch in ARCH_IDS


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_and_init_tree(arch):
    """``convert`` carries every leaf of the reference's tree bit for bit
    (Whisper's ``encoder``, ``enc_final_norm``, ``norm_cross`` and
    ``cross`` included), and the port's ``init_params`` builds the same
    tree: keys, shapes and dtypes."""
    jcfg, cfg, jp = _weights(arch)
    tp = params_from_reference(jp)
    own = tmodel.init_params(cfg, seed=0, device="cpu")
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    tl = dict(jax.tree_util.tree_flatten_with_path(tp)[0])
    ol = dict(jax.tree_util.tree_flatten_with_path(own)[0])
    assert set(tl) == set(ol) == {k for k, _ in jl}
    names = {jax.tree_util.keystr(k) for k, _ in jl}
    enc = {"['encoder']['mlp']['w_up']", "['enc_final_norm']['scale']",
           "['blocks']['0']['norm_cross']['scale']",
           "['blocks']['0']['cross']['wq']"}
    assert enc <= names if cfg.is_encoder_decoder else not enc & names
    for k, a in jl:
        t = tl[k]
        assert tuple(t.shape) == a.shape == tuple(ol[k].shape), k
        assert str(t.dtype).split(".")[-1] == a.dtype.name == \
            str(ol[k].dtype).split(".")[-1], k
        back = t.view(torch.uint16).numpy() if t.dtype == torch.bfloat16 \
            else t.numpy()
        raw = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
        assert np.array_equal(back, raw), k


def test_frontend_stubs():
    """The stub frontends give (B, encoder_seq, d) and (B,
    num_image_tokens, d) bf16 at the reference's scale (normal × 0.02),
    from the caller's generator; image embeddings go only into a VLM."""
    gen = torch.Generator().manual_seed(0)
    wcfg, lcfg = (get_config(a, reduced=True) for a in ARCHS)
    a = audio_frame_embeddings(gen, wcfg, 3)
    i = image_patch_embeddings(gen, lcfg, 2)
    assert a.shape == (3, wcfg.encoder_seq, wcfg.d_model)
    assert i.shape == (2, lcfg.num_image_tokens, lcfg.d_model)
    assert a.dtype == i.dtype == torch.bfloat16
    assert 0.015 < float(a.float().std()) < 0.025
    _, _, jp = _weights("whisper-tiny")
    with pytest.raises(ValueError, match="image_embeds"):
        tmodel._embed_inputs(params_from_reference(jp), wcfg,
                             torch.zeros((3, 2), dtype=torch.long), a)


def test_gelu_mlp_matches_reference():
    """The encoder's GELU MLP (tanh form, as ``jax.nn.gelu``'s default)
    against the reference's on one layer's weights."""
    _, _, jp = _weights("whisper-tiny")
    p = jax.tree_util.tree_map(lambda a: a[0], jp["encoder"]["mlp"])
    xa, xt = _bf16(np.random.default_rng(3), (2, 9, p["w_up"].shape[0]))
    want = JM.gelu_mlp(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(xa))
    got = M.gelu_mlp(params_from_reference(p), xt)
    assert got.dtype == torch.bfloat16
    _close(got, want, BLOCK_TOL)


def test_encode_matches_reference():
    """The whole encoder (attention over every frame with rope at frame
    positions, the GELU MLP, the final norm) against ``repro``'s
    ``encode`` on numpy-drawn frames."""
    jcfg, cfg, jp = _weights("whisper-tiny")
    fa, ft = _bf16(np.random.default_rng(4), (2, cfg.encoder_seq,
                                              cfg.d_model), 0.02)
    want = jmodel.encode(jax.tree_util.tree_map(jnp.asarray, jp), jcfg,
                         jnp.asarray(fa))
    got = tmodel.encode(params_from_reference(jp), cfg, ft)
    assert got.shape == (2, cfg.encoder_seq, cfg.d_model)
    _close(got, want, BLOCK_TOL)


@pytest.mark.parametrize("S,window,stride", [
    (24, None, 1), (24, 8, 1), (24, 8, 2), (2304, 300, 1)],
    ids=["causal", "window", "positions", "chunked"])
def test_attention_full_causal_matches_reference(S, window, stride):
    """``attention_full``'s causal branch (a decoder's attention over a
    whole sequence, no cache) against the reference's: the causal mask,
    a sliding window, given positions (row 1's ``stride`` apart: its
    rope and its window over them),
    and past ``PREFILL_CHUNK_THRESHOLD`` tokens, at a multiple of
    ``PREFILL_CHUNK``, the q-chunked loop under a window."""
    jcfg, cfg, jp = _weights("llava-next-34b")
    p = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["0"]["attn"])
    jattn = dataclasses.replace(jcfg.attn, sliding_window=window)
    attn = dataclasses.replace(cfg.attn, sliding_window=window)
    xa, xt = _bf16(np.random.default_rng(S + stride), (2, S, cfg.d_model))
    pos = np.arange(S)[None, :] * np.array([1, stride])[:, None]
    kw = {} if stride == 1 else dict(positions=jnp.asarray(pos))
    want = JL.attention_full(jax.tree_util.tree_map(jnp.asarray, p), jattn,
                             jnp.asarray(xa), causal=True, **kw)
    kw = {} if stride == 1 else dict(positions=torch.from_numpy(pos))
    got = L.attention_full(params_from_reference(p), attn, xt, causal=True,
                           **kw)
    assert got.shape == (2, S, cfg.d_model)
    _close(got, want, BLOCK_TOL)


@pytest.mark.parametrize("sq", [7, 1], ids=["prefill", "decode"])
def test_cross_attention_matches_reference(sq, monkeypatch):
    """``encode_cross_kv`` (no rope) and ``cross_attention`` against the
    reference's: at prefill (Sq = 7) through the plain masked attention,
    at decode (Sq = 1, a ``valid`` mask given) through ``ops.flash_decode``
    (its plain version here), once per call."""
    jcfg, cfg, jp = _weights("whisper-tiny")
    p = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["0"]["cross"])
    jpj = jax.tree_util.tree_map(jnp.asarray, p)
    tp = params_from_reference(p)
    rng = np.random.default_rng(5 + sq)
    ea, et = _bf16(rng, (2, cfg.encoder_seq, cfg.d_model))
    xa, xt = _bf16(rng, (2, sq, cfg.d_model))
    jk, jv = JL.encode_cross_kv(jpj, jcfg.attn, jnp.asarray(ea))
    k, v = L.encode_cross_kv(tp, cfg.attn, et)
    assert k.shape == (2, cfg.encoder_seq, cfg.attn.n_kv_heads,
                       cfg.attn.head_dim)
    _close(k, jk, 2.0 ** -8)
    _close(v, jv, 2.0 ** -8)
    calls = []
    entry = ops.flash_decode
    monkeypatch.setattr(ops, "flash_decode",
                        lambda *a: calls.append(a) or entry(*a))
    valid = torch.ones((2, cfg.encoder_seq), dtype=torch.bool) \
        if sq == 1 else None
    # Both sides attend over the same K/V: the reference's.
    kt, vt = to_torch(np.asarray(jk)), to_torch(np.asarray(jv))
    got = L.cross_attention(tp, cfg.attn, xt, kt, vt, valid)
    want = JL.cross_attention(jpj, jcfg.attn, jnp.asarray(xa), jk, jv)
    assert len(calls) == (sq == 1)
    _close(got, want, BLOCK_TOL)


def _margin(row):
    top = np.sort(np.asarray(row, np.float32))[-2:]
    return float(top[1] - top[0])


def _hold(got, want, held):
    """One forward's logits (B, V): within ``LOGIT_TOL``; each row's
    argmax the reference's unless its top-2 margin is below 4x that.
    Counts the rows whose greedy token was held."""
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= LOGIT_TOL
    for r in range(want.shape[0]):
        same = int(got[r].argmax()) == int(want[r].argmax())
        assert same or _margin(want[r]) < 4 * LOGIT_TOL, r
        held.append(same)


def _inputs(cfg, rng, B, S, lengths):
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    extra = {}
    if cfg.is_encoder_decoder:
        extra["audio_embeds"] = _bf16(rng, (B, cfg.encoder_seq, cfg.d_model),
                                      0.02)
    if cfg.family == "vlm":
        extra["image_embeds"] = _bf16(rng, (B, cfg.num_image_tokens,
                                            cfg.d_model), 0.02)
    n_img = cfg.num_image_tokens if cfg.family == "vlm" else 0
    return toks, extra, np.asarray(lengths, np.int32) + n_img


def _teacher_forced(arch, paged, seed):
    """Prefill of two right-padded rows (11 and 6 tokens; LLaVA's counted
    with their image prefix) and ``NEW_TOKENS`` decode steps on both
    packages, each step fed the reference's greedy tokens (the reference's
    entry points jitted once per test, as its engine runs them)."""
    jcfg, cfg, jp = _weights(arch)
    jpj = jax.tree_util.tree_map(jnp.asarray, jp)
    tp = params_from_reference(jp)
    B, S, bt, max_len = 2, 11, 16, 96
    toks, extra, lengths = _inputs(cfg, np.random.default_rng(seed), B, S,
                                   (11, 6))
    jbatch = {"tokens": jnp.asarray(toks),
              **{k: jnp.asarray(a) for k, (a, _) in extra.items()}}
    tkw = {k: t for k, (_, t) in extra.items()}
    tt = torch.from_numpy(toks).long()
    tl = torch.from_numpy(lengths).long()
    held = []
    if paged:
        nb = max_len // bt
        table = np.arange(1, 1 + B * nb, dtype=np.int32).reshape(B, nb)
        jc = jmodel.init_paged_caches(jcfg, B, max_len, bt, 1 + B * nb)
        jlg, jc, _ = jax.jit(functools.partial(jmodel.prefill_paged,
                                               cfg=jcfg))(
            jpj, batch=jbatch, caches=jc, block_table=jnp.asarray(table),
            start=jnp.zeros(B, jnp.int32), lengths=jnp.asarray(lengths))
        jstep = jax.jit(functools.partial(jmodel.decode_step_paged,
                                          cfg=jcfg))
        tc = tmodel.init_paged_caches(cfg, 1 + B * nb, bt, device="cpu")
        lg, _ = tmodel.prefill_paged(tp, cfg, tt, tc,
                                     torch.from_numpy(table),
                                     torch.zeros(B, dtype=torch.long), tl,
                                     **tkw)
    else:
        jc = jmodel.init_caches(jcfg, B, max_len)
        jlg, jc, _ = jax.jit(functools.partial(jmodel.prefill, cfg=jcfg))(
            jpj, batch=jbatch, caches=jc, lengths=jnp.asarray(lengths))
        jstep = jax.jit(functools.partial(jmodel.decode_step, cfg=jcfg))
        tc = tmodel.init_caches(cfg, B, max_len, device="cpu")
        lg, _ = tmodel.prefill(tp, cfg, tt, tc, tl, **tkw)
    _hold(lg, jlg, held)
    pos = lengths.copy()
    for _ in range(NEW_TOKENS):
        tok = np.asarray(jlg).argmax(-1).astype(np.int32)
        if paged:
            wb = table[np.arange(B), pos // bt]
            jlg, jc, _ = jstep(
                jpj, token=jnp.asarray(tok), pos_idx=jnp.asarray(pos),
                caches=jc, block_table=jnp.asarray(table),
                write_blk=jnp.asarray(wb), write_off=jnp.asarray(pos % bt))
            lg, _ = tmodel.decode_step_paged(
                tp, cfg, torch.from_numpy(tok).long(),
                torch.from_numpy(pos).long(), tc, torch.from_numpy(table),
                torch.from_numpy(wb).long(),
                torch.from_numpy(pos % bt).long())
        else:
            jlg, jc, _ = jstep(jpj, token=jnp.asarray(tok),
                               pos_idx=jnp.asarray(pos), caches=jc)
            lg, _ = tmodel.decode_step(tp, cfg, torch.from_numpy(tok).long(),
                                       torch.from_numpy(pos).long(), tc)
        _hold(lg, jlg, held)
        pos = pos + 1
    assert sum(held) >= len(held) - 2, held
    return tc, jc


def test_whisper_batch_entry_points(monkeypatch):
    """Whisper on dense rows: the prefill encodes the frames and fills
    every layer's cross K/V (equal to the reference's), then 8 decode
    steps, each running cross-attention through ``ops.flash_decode`` (two
    calls per layer and step: self- and cross-attention)."""
    calls = []
    entry = ops.flash_decode
    monkeypatch.setattr(ops, "flash_decode",
                        lambda *a: calls.append(a[1].shape) or entry(*a))
    _, cfg, _ = _weights("whisper-tiny")
    tc, jc = _teacher_forced("whisper-tiny", False, 11)
    assert tc[tmodel.CROSS].k.shape == (cfg.n_layers, 2, cfg.encoder_seq,
                                        cfg.attn.n_kv_heads,
                                        cfg.attn.head_dim)
    # The encoder's output a few bf16 roundings apart, projected once.
    _close(tc[tmodel.CROSS].k, jc.cross["k"], BLOCK_TOL)
    _close(tc[tmodel.CROSS].v, jc.cross["v"], BLOCK_TOL)
    assert len(calls) == 2 * cfg.n_layers * NEW_TOKENS
    assert sum(s[1] == cfg.encoder_seq for s in calls) == \
        cfg.n_layers * NEW_TOKENS


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_llava_image_prefill(paged):
    """LLaVA with image embeddings ahead of the prompt: ``prefill`` on
    dense rows, or ``prefill_paged`` at start 0 (``lengths`` counting the
    image prefix), then decode steps on the same layout."""
    _teacher_forced("llava-next-34b", paged, 12 + paged)


def _engine_pair(paged):
    jcfg, cfg, jp = _weights("llava-next-34b")
    ecfg = dict(max_slots=2, max_len=96, paged=paged)
    je = JInferenceEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, jp),
                          jmake_backend("fp16"),
                          JEngineConfig(prefix_sharing=False, **ecfg))
    te = InferenceEngine(cfg, params_from_reference(jp),
                         make_backend("fp16", device="cpu"),
                         EngineConfig(**ecfg), device="cpu")
    return je, te


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_llava_token_only_engine_matches_reference(paged, monkeypatch):
    """LLaVA's token-only requests through both engines (``fp16``, three
    prompts over two slots), step by step under the margin rule; the
    multimodal batch stays refused by ``generate`` in both."""
    je, te = _engine_pair(paged)
    prompts = [make_prompts("text", te.cfg.vocab_size, 1, n, seed=n)[0]
               for n in (5, 19, 40)]
    results = _serve_lockstep(te.cfg, je, te, monkeypatch, paged=paged,
                              tol=LOGIT_TOL, prompts=prompts,
                              new_tokens=NEW_TOKENS)
    held = 0
    for ref_toks, port_toks, stop, _ in results:
        assert len(port_toks) == NEW_TOKENS
        upto = NEW_TOKENS if stop is None else stop[0]
        assert port_toks[:upto] == ref_toks[:upto]
        held += upto
    assert held >= 2 * NEW_TOKENS, results
    assert (te.pool is None) == (je.pool is None) == (not paged)
    batch = {"tokens": np.zeros((1, 4), np.int32),
             "image_embeds": np.zeros((1, 16, te.cfg.d_model), np.float32)}
    for eng in (je, te):
        with pytest.raises(NotImplementedError, match="token-only"):
            eng.generate(batch, 2)


@pytest.mark.parametrize("where", ["engine", "paged", "launcher"])
def test_whisper_refused_as_the_reference(where):
    """Where the reference refuses an encoder-decoder stack the port does
    too: ``InferenceEngine`` (both raise ``NotImplementedError`` naming
    the batch entry points), the paged caches and prefill (and the port's
    paged decode), and the launcher (through the engine's refusal)."""
    jcfg, cfg, jp = _weights("whisper-tiny")
    tp = params_from_reference(jp)
    if where == "engine":
        with pytest.raises(NotImplementedError, match="decoder-only"):
            JInferenceEngine(jcfg, jp, jmake_backend("fp16"),
                             JEngineConfig())
        with pytest.raises(NotImplementedError, match="decoder-only"):
            InferenceEngine(cfg, tp, make_backend("fp16", device="cpu"),
                            EngineConfig(), device="cpu")
    elif where == "paged":
        with pytest.raises(NotImplementedError, match="decoder-only"):
            jmodel.init_paged_caches(jcfg, 2, 64, 16, 9)
        with pytest.raises(NotImplementedError, match="decoder-only"):
            jmodel.prefill_paged(jp, jcfg, {"tokens": np.zeros((1, 4))},
                                 None, None, None, None)
        one = torch.zeros(1, dtype=torch.long)
        for call in (
                lambda: tmodel.init_paged_caches(cfg, 9, 16, device="cpu"),
                lambda: tmodel.prefill_paged(tp, cfg, one[None], {}, None,
                                             one, one),
                lambda: tmodel.decode_step_paged(tp, cfg, one, one, {},
                                                 None, one, one)):
            with pytest.raises(NotImplementedError, match="decoder-only"):
                call()
    else:
        with pytest.raises(NotImplementedError, match="decoder-only"):
            serve.main(["--arch", "whisper-tiny", "--backend", "fp16",
                        "--batch", "2", "--prompt-len", "8",
                        "--new-tokens", "2", "--no-spec", "--device", "cpu"])
        out = serve.main(["--arch", "llava-next-34b", "--backend", "fp16",
                          "--batch", "2", "--prompt-len", "8",
                          "--new-tokens", "2", "--no-spec", "--device",
                          "cpu"])
        assert [len(t) for t in out["tokens"]] == [2, 2]
        assert out["device_bytes"] == 0
