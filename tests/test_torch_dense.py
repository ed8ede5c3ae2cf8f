"""The port's dense-row KV path (attention over (B, Hkv, C, hd) rows, the
``prefill``/``decode_step`` entry points with padded MoE dispatch) against
the reference, on one set of converted weights."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import decode_step as jdecode_step
from repro.models import init_caches as jinit_caches
from repro.models import init_params as jinit_params
from repro.models import layers as jlayers
from repro.models import prefill as jprefill
from repro_torch.configs import get_config
from repro_torch.convert import (bank_from_reference, params_from_reference,
                                 to_torch)
from repro_torch.models import layers as tlayers
from repro_torch.models.model import decode_step, init_caches, prefill
from test_torch_model import LOGIT_ATOL, _bank_with_hi
from torch_threads import _one_thread  # noqa: F401

ARCH = "qwen3-moe-30b-a3b"


@pytest.fixture(scope="module")
def attn():
    jcfg = jget_config(ARCH, reduced=True)
    jp = jinit_params(jax.random.PRNGKey(3), jcfg)
    jattn = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["0"]["attn"])
    tattn = params_from_reference(jax.tree_util.tree_map(np.asarray, jattn))
    return jcfg, get_config(ARCH, reduced=True), jattn, tattn


def _cache(jcfg, B, C, seed):
    """A dense cache holding earlier contents (random), so the tests see
    which slots a write keeps."""
    rng = np.random.default_rng(seed)
    shape = (B, jcfg.attn.n_kv_heads, C, jcfg.attn.head_dim)
    jc = jlayers.KVCache(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16),
                         jnp.asarray(rng.standard_normal(shape), jnp.bfloat16))
    return jc, tlayers.KVCache(to_torch(jc.k), to_torch(jc.v))


def _ulps(t, j):
    """Cache contents agree to one bf16 ulp: the K/V projections are bf16
    GEMMs whose partial sums both libraries round in their own ways."""
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=2 ** -7, atol=2 ** -7)


def test_attention_prefill_matches_reference(attn):
    jcfg, cfg, jattn, tattn = attn
    B, S, C = 3, 32, 48
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((B, S, jcfg.d_model)), jnp.bfloat16)
    lengths = np.array([20, 0, 32])                 # row 1: an inert pad row
    jc, tc = _cache(jcfg, B, C, seed=1)
    jo, jc2 = jlayers.attention_prefill(jattn, jcfg.attn, x, jc,
                                        lengths=jnp.asarray(lengths))
    to = tlayers.attention_prefill(tattn, cfg.attn, to_torch(x), tc,
                                   torch.from_numpy(lengths))
    _ulps(tc.k, jc2.k)
    _ulps(tc.v, jc2.v)
    # Slots no real position maps to keep their contents, bit for bit.
    keep = np.arange(C)[None, :] >= lengths[:, None]
    np.testing.assert_array_equal(
        tc.k.float().numpy().transpose(0, 2, 1, 3)[keep],
        np.asarray(jc.k, np.float32).transpose(0, 2, 1, 3)[keep])
    # Outputs at real positions: both mask with -1e30 and round the
    # probabilities to bf16; the projections differ by ulps.
    for r, n in enumerate(lengths):
        np.testing.assert_allclose(to[r, :n].float().numpy(),
                                   np.asarray(jo[r, :n], np.float32),
                                   rtol=0.05, atol=0.05)


@pytest.mark.parametrize("S,window", [(2304, None), (2304, 64),
                                      (2049, None)],
                         ids=["chunked", "chunked-window", "whole"])
def test_attention_prefill_chunked_matches_reference(attn, S, window,
                                                     monkeypatch):
    """Past 2048 tokens at a multiple of 256 the prefill attends chunk by
    chunk (the reference's ``_sdpa_chunked``), with and without a window;
    at 2049 it runs the whole masked attention. Both against the
    reference's ``attention_prefill``, to the prefill tolerance above."""
    jcfg, cfg, jattn, tattn = attn
    ja = dataclasses.replace(jcfg.attn, sliding_window=window)
    ta = dataclasses.replace(cfg.attn, sliding_window=window)
    rng = np.random.default_rng(S + (window or 0))
    x = jnp.asarray(rng.standard_normal((1, S, jcfg.d_model)), jnp.bfloat16)
    lengths = np.array([S])
    jc, tc = _cache(jcfg, 1, S if window is None else window, seed=2)
    chunked = []
    monkeypatch.setattr(tlayers, "_sdpa_chunked", lambda *a: chunked.append(
        a[-1]) or _SDPA_CHUNKED(*a))
    jo, jc2 = jlayers.attention_prefill(jattn, ja, x, jc,
                                        lengths=jnp.asarray(lengths))
    to = tlayers.attention_prefill(tattn, ta, to_torch(x), tc,
                                   torch.from_numpy(lengths))
    assert chunked == ([tlayers.PREFILL_CHUNK] if S % 256 == 0 else [])
    _ulps(tc.k, jc2.k)
    _ulps(tc.v, jc2.v)
    np.testing.assert_allclose(to[0].float().numpy(),
                               np.asarray(jo[0], np.float32),
                               rtol=0.05, atol=0.05)


_SDPA_CHUNKED = tlayers._sdpa_chunked


def test_attention_prefill_matches_reference_on_sliding_window_rings(attn):
    """Sliding-window rings on dense rows: a ring of capacity
    ``min(max_len, window)`` smaller than the bucket takes each row's last
    ``C`` real positions at slot ``pos % C`` (a short row wraps less, an
    inert row keeps its slots), and the window mask, as the reference's
    ``attention_prefill``; also past the plain attention's length at a
    length the chunked attention does not take (2049: the whole masked
    attention over a ring)."""
    jcfg, cfg, jattn, tattn = attn
    B, S, W = 3, 32, 12
    jring = dataclasses.replace(jcfg.attn, sliding_window=W)
    ring = dataclasses.replace(cfg.attn, sliding_window=W)
    rng = np.random.default_rng(8)
    x = jnp.asarray(rng.standard_normal((B, S, jcfg.d_model)), jnp.bfloat16)
    lengths = np.array([20, 0, 32])
    jc, tc = _cache(jcfg, B, W, seed=9)
    jo, jc2 = jlayers.attention_prefill(jattn, jring, x, jc,
                                        lengths=jnp.asarray(lengths))
    to = tlayers.attention_prefill(tattn, ring, to_torch(x), tc,
                                   torch.from_numpy(lengths))
    _ulps(tc.k, jc2.k)
    _ulps(tc.v, jc2.v)
    np.testing.assert_array_equal(tc.k[1].float().numpy(),
                                  np.asarray(jc.k[1], np.float32))
    for r, n in enumerate(lengths):
        np.testing.assert_allclose(to[r, :n].float().numpy(),
                                   np.asarray(jo[r, :n], np.float32),
                                   rtol=0.05, atol=0.05)
    x_long = jnp.asarray(rng.standard_normal((1, 2049, jcfg.d_model)),
                         jnp.bfloat16)
    jc, tc = _cache(jcfg, 1, W, seed=0)
    jo, jc2 = jlayers.attention_prefill(jattn, jring, x_long, jc,
                                        lengths=jnp.asarray([2049]))
    to = tlayers.attention_prefill(tattn, ring, to_torch(x_long), tc,
                                   torch.tensor([2049]))
    _ulps(tc.k, jc2.k)
    np.testing.assert_allclose(to[0].float().numpy(),
                               np.asarray(jo[0], np.float32),
                               rtol=0.05, atol=0.05)


def test_attention_decode_matches_reference(attn):
    jcfg, cfg, jattn, tattn = attn
    B, C = 3, 48
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.standard_normal((B, 1, jcfg.d_model)), jnp.bfloat16)
    pos = np.array([0, 17, C - 1])
    jc, tc = _cache(jcfg, B, C, seed=5)
    jo, jc2 = jlayers.attention_decode(jattn, jcfg.attn, x,
                                       jnp.asarray(pos, jnp.int32), jc)
    to = tlayers.attention_decode(tattn, cfg.attn, to_torch(x),
                                  torch.from_numpy(pos), tc)
    # The in-place write touches slot pos % C of each row only.
    _ulps(tc.k, jc2.k)
    _ulps(tc.v, jc2.v)
    written = np.arange(C)[None, :] == pos[:, None]
    np.testing.assert_array_equal(
        tc.k.float().numpy().transpose(0, 2, 1, 3)[~written],
        np.asarray(jc.k, np.float32).transpose(0, 2, 1, 3)[~written])
    # The reference (_attend_cache) masks with -1e30 and rounds logits and
    # probabilities to bf16 before the PV dot; the port's kernel keeps
    # float32 with -inf: a few bf16 ulps of the attention output, which the
    # output projection sums over.
    np.testing.assert_allclose(to.float().numpy(), np.asarray(jo, np.float32),
                               rtol=0.05, atol=0.05)


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("H,Hkv,hd,window", [(32, 8, 120, 48),
                                             (32, 32, 128, None),
                                             (24, 8, 128, None)],
                         ids=["danube", "deepseek", "llama"])
def test_decode_attention_head_shapes_match_reference(layout, H, Hkv, hd,
                                                      window):
    """The decode attention's plain versions at the dense families' head
    shapes (hd 120 rep 4 on a window ring past its wrap, hd 128 rep 1, hd
    128 rep 3), on dense rows and through a block table, against the
    reference's ``_attend_cache`` over the same cache view, to the decode
    tolerance above."""
    from repro.models.config import AttnConfig as JAttnConfig
    from repro_torch.kernels import ops as kops
    from repro_torch.models.config import AttnConfig
    B, C, bt = 3, 48, 16
    jcfg = JAttnConfig(n_heads=H, n_kv_heads=Hkv, head_dim=hd,
                       sliding_window=window)
    cfg = AttnConfig(n_heads=H, n_kv_heads=Hkv, head_dim=hd,
                     sliding_window=window)
    rng = np.random.default_rng(hd + H + Hkv)
    q = rng.standard_normal((B, 1, H, hd))
    kc = rng.standard_normal((B, Hkv, C, hd))
    vc = rng.standard_normal((B, Hkv, C, hd))
    pos = np.array([0, 17, 3 * C + 5])             # the last row wrapped
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, kc, vc))
    want = np.asarray(jlayers._attend_cache(jq, jk, jv,
                                            jnp.asarray(pos), jcfg),
                      np.float32).reshape(B, H, hd)
    tq, tk, tv = (to_torch(a) for a in (jq, jk, jv))
    valid = tlayers.decode_valid(torch.from_numpy(pos), C, cfg)
    if layout == "dense":
        got = kops.flash_decode(tq[:, 0].contiguous(), tk.transpose(1, 2),
                                tv.transpose(1, 2), valid)
    else:
        nb = C // bt
        table = torch.from_numpy((1 + rng.permutation(B * nb)).reshape(
            B, nb).astype(np.int32))
        pool = [torch.zeros((1 + B * nb, Hkv, bt, hd), dtype=torch.bfloat16)
                for _ in range(2)]
        for p, src in zip(pool, (tk, tv)):
            p[table.long()] = src.reshape(B, Hkv, nb, bt, hd).transpose(1, 2)
        got = kops.flash_decode_paged(tq[:, 0].contiguous(), *pool, table,
                                      valid)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0.05,
                               atol=0.05)


def _forward_pair(arch, steps=8, B=3, max_len=64, seed=0):
    """Dense prefill + teacher-forced decode with padded dispatch through
    both packages. Yields per forward (logits_ref, logits_port,
    counts_ref, counts_port)."""
    jcfg = jget_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    jp = jinit_params(jax.random.PRNGKey(seed), jcfg)
    jbank = _bank_with_hi(jp["blocks"]["0"]["moe"]["experts"])
    tp = params_from_reference(jax.tree_util.tree_map(np.asarray, jp))
    tbank = {"0": bank_from_reference(jbank)}
    rng = np.random.default_rng(seed)
    lengths = np.array([20, 13, 32])[:B]
    S = 32
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    kw = dict(per_row_counts=True, moe_dispatch="padded")
    jpre = jax.jit(functools.partial(jprefill, cfg=jcfg, **kw))
    jdec = jax.jit(functools.partial(jdecode_step, cfg=jcfg, **kw))
    jc = jinit_caches(jcfg, B, max_len)
    tc = init_caches(cfg, B, max_len, device="cpu")
    lj, jc, cj = jpre(jp, batch={"tokens": jnp.asarray(toks)}, caches=jc,
                      bank={"0": jbank}, lengths=jnp.asarray(lengths,
                                                             jnp.int32))
    lt, ct = prefill(tp, cfg, torch.from_numpy(toks).long(), tc,
                     torch.from_numpy(lengths), bank=tbank, **kw)
    yield np.asarray(lj), lt.numpy(), np.asarray(cj["0"]), ct["0"].numpy()
    pos = lengths.copy()
    for _ in range(steps):
        tok = rng.integers(0, cfg.vocab_size, B).astype(np.int32)
        lj, jc, cj = jdec(jp, token=jnp.asarray(tok),
                          pos_idx=jnp.asarray(pos, jnp.int32), caches=jc,
                          bank={"0": jbank})
        lt, ct = decode_step(tp, cfg, torch.from_numpy(tok).long(),
                             torch.from_numpy(pos), tc, bank=tbank, **kw)
        yield np.asarray(lj), lt.numpy(), np.asarray(cj["0"]), \
            ct["0"].numpy()
        pos += 1


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "qwen3-moe-30b-a3b"])
def test_teacher_forced_logits_match_reference(arch):
    """As the paged test in test_torch_model: each row is compared until
    the first forward in which its router picked other experts than the
    reference's (a top-k near tie tipped by bf16 ulps), after which its
    hidden states legitimately diverge; such rows must stay rare."""
    diverged = set()
    compared = 0
    for lj, lt, cj, ct in _forward_pair(arch):
        assert np.isfinite(lt).all()
        for r in range(lj.shape[0]):
            if r in diverged:
                continue
            if not np.array_equal(cj[:, r], ct[:, r]):
                diverged.add(r)
                continue
            np.testing.assert_allclose(lt[r], lj[r], rtol=0,
                                       atol=LOGIT_ATOL)
            assert lt[r].argmax() == lj[r].argmax() or \
                np.sort(lj[r])[-1] - np.sort(lj[r])[-2] < 2 * LOGIT_ATOL
            compared += 1
    assert len(diverged) <= 1, f"rows {sorted(diverged)} diverged"
    assert compared >= 2 * 9
