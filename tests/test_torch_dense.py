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


def test_attention_prefill_refuses_the_chunked_length(attn):
    jcfg, cfg, _, tattn = attn
    x = torch.zeros((1, 2049, jcfg.d_model), dtype=torch.bfloat16)
    _, tc = _cache(jcfg, 1, 2049, seed=0)
    with pytest.raises(NotImplementedError, match="chunked"):
        tlayers.attention_prefill(tattn, cfg.attn, x, tc,
                                  torch.tensor([2049]))


def test_attention_prefill_refuses_sliding_window_rings(attn):
    jcfg, cfg, _, tattn = attn
    x = torch.zeros((1, 8, jcfg.d_model), dtype=torch.bfloat16)
    _, tc = _cache(jcfg, 1, 4, seed=0)
    ring = dataclasses.replace(cfg.attn, sliding_window=4)
    with pytest.raises(NotImplementedError, match="sliding-window"):
        tlayers.attention_prefill(tattn, ring, x, tc, torch.tensor([8]))


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
