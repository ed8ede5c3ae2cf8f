"""The port's MoE dispatch and model entry points against the reference,
on one set of converted weights."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.ver import build_bank as jbuild_bank
from repro.models import init_paged_caches as jinit_paged_caches
from repro.models import init_params as jinit_params
from repro.models import decode_step_paged as jdecode_step_paged
from repro.models import prefill_paged as jprefill_paged
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.convert import (bank_from_reference, params_from_reference,
                                 to_torch)
from repro_torch.models import moe as tmoe
from repro_torch.models.model import (decode_step_paged, init_paged_caches,
                                      prefill_paged)

# Logit tolerance for the bf16 models: the port attends decode tokens in
# float32 (its flash kernel's arithmetic) where the reference rounds logits
# and probabilities to bf16, and rope's sin/cos come from another library;
# hidden states then differ by a few bf16 ulps (2^-8 relative), which the
# final projection turns into a few hundredths on logits of magnitude ~1-4.
LOGIT_ATOL = 0.1


def _bank_with_hi(experts, n_hi=2, owners=(1, 3)):
    """Reference bank with ``owners`` published into the hi slots of every
    layer, so both tiers run."""
    bank = jbuild_bank(experts, n_hi=n_hi, lo_bits=4)
    L, E = experts["w_gate"].shape[:2]
    for n in bank.hi:
        for l in range(L):
            for s, e in enumerate(owners):
                bank.hi[n] = bank.hi[n].at[l, s].set(experts[n][l, e])
    bank.slot_owner = jnp.asarray([list(owners)] * L, jnp.int32)
    sm = np.full((L, E), -1, np.int32)
    for s, e in enumerate(owners):
        sm[:, e] = s
    bank.slot_map = jnp.asarray(sm)
    return bank


@pytest.fixture(scope="module")
def qwen_bank():
    cfg = jget_config("qwen3-moe-30b-a3b", reduced=True)
    params = jinit_params(jax.random.PRNGKey(1), cfg)
    return cfg, params, _bank_with_hi(params["blocks"]["0"]["moe"]["experts"])


@pytest.mark.parametrize("T,capacity,row_capacity", [
    (16, 64, None),        # drop-free
    (24, 8, None),         # tight global capacity: drops
    (24, 48, 2),           # per-row rule over 4 rows of 6 tokens
])
def test_dispatch_ragged_matches_reference(qwen_bank, T, capacity,
                                           row_capacity):
    cfg, params, jbank = qwen_bank
    E, k, d = cfg.moe.num_experts, cfg.moe.top_k, cfg.d_model
    rng = np.random.default_rng(T + capacity)
    x = jnp.asarray(rng.standard_normal((T, d)), jnp.bfloat16)
    idx = rng.integers(0, E, (T, k)).astype(np.int32)
    idx[3, :] = E                                  # one masked token
    gates = rng.uniform(0.1, 1.0, (T, k)).astype(np.float32)
    gates[idx == E] = 0.0
    jl = jax.tree_util.tree_map(lambda a: a[0], jbank)
    n_rows = 4 if row_capacity else None
    # Op by op (not jitted): every bf16 rounding of the reference happens
    # where its source puts it, which the port mirrors.
    yj, cj, dj, pj = jmoe._dispatch_ragged(
        jl, x, jnp.asarray(idx), jnp.asarray(gates), E, capacity,
        row_capacity=row_capacity, n_rows=n_rows)
    tl = bank_from_reference(jbank).layer(0)
    yt, ct, dt, pt = tmoe._dispatch_ragged(
        tl, to_torch(x), torch.from_numpy(idx).long(),
        torch.from_numpy(gates), E, capacity, row_capacity=row_capacity,
        n_rows=n_rows)
    np.testing.assert_array_equal(np.asarray(cj), ct.numpy())
    assert float(dj) == float(dt)
    assert float(pj) == float(pt)
    # Same layout, same per-tile math (the plain FFN is bit-equal to the
    # reference's jnp oracle), same combine order and roundings.
    np.testing.assert_allclose(yt.float().numpy(), np.asarray(yj, np.float32),
                               rtol=2 ** -7, atol=2 ** -7)


def test_tile_map_matches_reference():
    rng = np.random.default_rng(5)
    for _ in range(5):
        counts = rng.integers(0, 20, 6).astype(np.int32)
        counts[rng.integers(0, 6)] = 0
        n_assign = int(counts.sum()) + 3
        ja, je, jn = jmoe.ragged_tile_map(jnp.asarray(counts), 8, n_assign)
        ta, te, tn = tmoe.ragged_tile_map(torch.from_numpy(counts), 8,
                                          n_assign)
        np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
        np.testing.assert_array_equal(np.asarray(je), te.numpy())
        assert int(jn) == int(tn[0])


def _forward_pair(arch, steps=8, B=3, bt=16, max_len=64, seed=0):
    """Prefill + teacher-forced decode through both packages. Yields per
    forward (logits_ref, logits_port, counts_ref, counts_port)."""
    jcfg = jget_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    jp = jinit_params(jax.random.PRNGKey(seed), jcfg)
    jbank = _bank_with_hi(jp["blocks"]["0"]["moe"]["experts"])
    tp = params_from_reference(jax.tree_util.tree_map(np.asarray, jp))
    tbank = {"0": bank_from_reference(jbank)}
    nb = max_len // bt
    N = 1 + B * nb
    rng = np.random.default_rng(seed)
    lengths = np.array([20, 13, 32])[:B]
    S = 32
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    table = np.arange(1, N).reshape(B, nb).astype(np.int32)
    jc = jinit_paged_caches(jcfg, B, max_len, bt, N)
    jprefill = jax.jit(functools.partial(
        jprefill_paged, cfg=jcfg, per_row_counts=True, moe_dispatch="ragged"))
    jdecode = jax.jit(functools.partial(
        jdecode_step_paged, cfg=jcfg, per_row_counts=True,
        moe_dispatch="ragged"))
    tc = init_paged_caches(cfg, N, bt, device="cpu")
    lj, jc, cj = jprefill(
        jp, batch={"tokens": jnp.asarray(toks)}, caches=jc,
        block_table=jnp.asarray(table), start=jnp.zeros(B, jnp.int32),
        lengths=jnp.asarray(lengths, jnp.int32), bank={"0": jbank})
    lt, ct = prefill_paged(
        tp, cfg, torch.from_numpy(toks).long(), tc, torch.from_numpy(table),
        torch.zeros(B, dtype=torch.long), torch.from_numpy(lengths),
        bank=tbank, per_row_counts=True)
    yield np.asarray(lj), lt.numpy(), np.asarray(cj["0"]), ct["0"].numpy()
    pos = lengths.copy()
    for _ in range(steps):
        tok = rng.integers(0, cfg.vocab_size, B).astype(np.int32)
        wb, wo = table[np.arange(B), pos // bt], pos % bt
        lj, jc, cj = jdecode(
            jp, token=jnp.asarray(tok), pos_idx=jnp.asarray(pos, jnp.int32),
            caches=jc, block_table=jnp.asarray(table),
            write_blk=jnp.asarray(wb, jnp.int32),
            write_off=jnp.asarray(wo, jnp.int32), bank={"0": jbank})
        lt, ct = decode_step_paged(
            tp, cfg, torch.from_numpy(tok).long(), torch.from_numpy(pos), tc,
            torch.from_numpy(table), torch.from_numpy(wb).long(),
            torch.from_numpy(wo).long(), bank=tbank, per_row_counts=True)
        yield np.asarray(lj), lt.numpy(), np.asarray(cj["0"]), \
            ct["0"].numpy()
        pos += 1


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "qwen3-moe-30b-a3b"])
def test_teacher_forced_logits_match_reference(arch):
    """Each row is compared at every forward until the first forward in
    which its router picked other experts than the reference's: a near tie
    in the top-k (these reduced models route top-2 of 4) that the small
    numeric differences above can tip, after which the row's hidden states
    legitimately diverge. Such divergences must stay rare."""
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
