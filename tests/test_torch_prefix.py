"""The sharing half of the port's paged KV against the reference's: the
pool, its leases and the prefix trie (``repro.serving.{kvpool,prefix}``)
driven through the same operations end in the same state — copy-on-write
of a shared block and eviction under quota pressure included — and the
suffix prefill over cached prefix blocks (``attention_prefill_paged``
with ``has_prefix``) computes the reference's outputs and K/V."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.budget import BudgetTracker as JBudgetTracker
from repro.models import init_params as jinit_params
from repro.models import layers as jlayers
from repro.serving import kvpool as jkvpool
from repro.serving import prefix as jprefix
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference, to_torch
from repro_torch.core.budget import BudgetTracker
from repro_torch.models import layers as L
from repro_torch.serving import kvpool, prefix
from torch_threads import _one_thread  # noqa: F401

BT = 4


class Twin:
    """One pool, trie and set of leases per package, driven in lockstep."""

    def __init__(self, n_blocks, cap_blocks=None):
        cap = None if cap_blocks is None else cap_blocks * 10
        self.sides = []
        for kv, pf, budget in ((kvpool, prefix, BudgetTracker),
                               (jkvpool, jprefix, JBudgetTracker)):
            b = None if cap is None else budget(cap).view("kv")
            trie = []
            pool = kv.KVBlockPool(n_blocks, BT, 10, budget=b,
                                  reclaim=lambda n, t=trie: t[0].evict(n))
            trie.append(pf.PrefixTrie(pool))
            self.sides.append({"kv": kv, "pool": pool, "trie": trie[0],
                               "leases": {}})

    def do(self, fn):
        outs = [fn(s) for s in self.sides]
        assert outs[0] == outs[1], outs
        self.check()
        return outs[0]

    def check(self):
        a, b = self.sides
        pa, pb = a["pool"], b["pool"]
        assert np.array_equal(pa.refcount, pb.refcount)
        assert pa._free == pb._free
        assert pa.quota_blocks == pb.quota_blocks
        assert pa.stats == pb.stats
        assert a["trie"].n_nodes == b["trie"].n_nodes
        assert a["trie"].stats == b["trie"].stats
        assert sorted(a["leases"]) == sorted(b["leases"])
        for k in a["leases"]:
            la, lb = a["leases"][k], b["leases"][k]
            assert np.array_equal(la.table, lb.table)
            assert la.quota == lb.quota and la.blocks() == lb.blocks()
        if pa.budget is not None:
            assert pa.budget.used == pb.budget.used
        pa.check_invariants()
        pb.check_invariants()


def _lease(name, quota):
    def fn(s):
        if not s["pool"].try_reserve_quota(quota):
            return False
        s["leases"][name] = s["kv"].KVLease(s["pool"], 8, quota)
        return True
    return fn


def _ensure(name, j):
    return lambda s: s["leases"][name].ensure(j)


def _close(name):
    return lambda s: s["leases"].pop(name).close()


def _insert(name, toks, n):
    return lambda s: s["trie"].insert(toks, [int(b) for b in
                                             s["leases"][name].table[:n]])


def _adopt(name, toks, max_blocks):
    def fn(s):
        hits = s["trie"].match(toks, max_blocks=max_blocks)
        for blk in hits:
            s["pool"].retain(blk)
        s["leases"][name].adopt_prefix(hits, retained=True)
        return hits
    return fn


def test_leases_trie_and_cow_equal_reference():
    t = Twin(n_blocks=16)
    sys_toks = np.arange(12)
    toks_a = np.concatenate([sys_toks, [50, 51, 52, 53, 54]])
    toks_b = np.concatenate([sys_toks, [60, 61, 62, 63]])
    assert t.do(_lease("a", 6))
    for j in range(4):
        t.do(_ensure("a", j))
    assert t.do(_insert("a", toks_a, 4)) == 4
    assert t.do(_lease("b", 6))
    assert len(t.do(_adopt("b", toks_b, 3))) == 3
    # Writing into an adopted (shared) block copies it on write.
    phys, src = t.do(_ensure("b", 2))
    assert src >= 0 and phys != src
    t.do(_ensure("b", 3))
    t.do(_insert("b", toks_b, 4))
    # A burst-fresh private block rewinds onto the lease's quota.
    t.do(_ensure("b", 4))
    t.do(lambda s: s["leases"]["b"].unwind(4))
    with pytest.raises(RuntimeError, match="shared block"):
        t.sides[0]["leases"]["b"].unwind(0)
    t.do(_close("a"))
    t.do(_close("b"))
    assert t.do(lambda s: s["trie"].n_nodes) == 5
    assert t.do(lambda s: s["trie"].clear()) == 5
    assert t.do(lambda s: s["pool"].blocks_in_use) == 0


def test_eviction_under_quota_pressure_equal_reference():
    """A budget of 10 blocks: trie-only blocks are reclaimed (LRU leaf
    first) before a quota reservation is refused."""
    t = Twin(n_blocks=16, cap_blocks=10)
    for i, name in enumerate("abc"):
        assert t.do(_lease(name, 3))
        for j in range(2):
            t.do(_ensure(name, j))
        t.do(_insert(name, np.arange(8) + 100 * i, 2))
        t.do(_close(name))
    assert t.do(lambda s: s["trie"].n_nodes) == 6
    # 1 trash + 6 trie blocks in use: 7 blocks of quota need 4 evictions.
    assert t.do(_lease("d", 7))
    assert t.do(lambda s: s["trie"].stats["evicted"]) == 4
    assert t.do(lambda s: s["pool"].stats["reclaimed"]) == 4
    assert not t.do(_lease("e", 3))
    assert t.do(lambda s: s["pool"].stats["quota_denied"]) == 1
    t.do(_close("d"))


def test_check_invariants_catches_a_broken_pool():
    pool = kvpool.KVBlockPool(6, BT, 10)
    pool._free.append(pool._free[0])
    with pytest.raises(AssertionError):
        pool.check_invariants()
    with pytest.raises(RuntimeError, match="dead block"):
        kvpool.KVBlockPool(6, BT, 10).retain(3)


# --------------------------------------------------------------------------
# suffix prefill over cached prefix blocks
# --------------------------------------------------------------------------

# The reference rounds logits and probabilities to bf16 where the port's
# plain attention keeps float32 softmax statistics the same way, but rope's
# sin/cos come from another library: K differs by at most one bf16 ulp
# (ROADMAP Queue 3), which moves the bf16 outputs by a few ulps.
OUT_ATOL = 2.0 ** -5


def _ulps(a, b):
    """bf16 ulps between two bf16 arrays (as int16 bit patterns)."""
    ia = a.view(np.int16).astype(np.int32)
    ib = b.view(np.int16).astype(np.int32)
    ia = np.where(ia < 0, -32768 - ia, ia)
    ib = np.where(ib < 0, -32768 - ib, ib)
    return np.abs(ia - ib)


@pytest.mark.parametrize("starts", [(16, 32, 0), (48, 16, 16)])
def test_has_prefix_attention_equals_reference(starts):
    jcfg = jget_config("granite-moe-1b-a400m", reduced=True)
    cfg = get_config("granite-moe-1b-a400m", reduced=True)
    jp = jinit_params(jax.random.PRNGKey(2), jcfg)
    jattn = jax.tree_util.tree_map(lambda a: a[0],
                                   jp["blocks"]["0"]["attn"])
    tattn = params_from_reference(jax.tree_util.tree_map(np.asarray, jattn))
    a = cfg.attn
    rng = np.random.default_rng(sum(starts))
    B, S, bt, nb = 3, 24, 16, 6
    N = 1 + B * nb
    starts = np.asarray(starts, np.int32)
    lengths = starts + np.asarray([S, 9, S - 3], np.int32)
    table = np.arange(1, N).reshape(B, nb).astype(np.int32)
    table[2, 4:] = -1                          # unallocated tail
    shape = (N, a.n_kv_heads, bt, a.head_dim)
    k0 = rng.normal(size=shape).astype(jnp.bfloat16)
    v0 = rng.normal(size=shape).astype(jnp.bfloat16)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(jnp.bfloat16)
    jout, jcache = jlayers.attention_prefill_paged(
        jattn, jcfg.attn, jnp.asarray(x), jlayers.PagedKVCache(
            jnp.asarray(k0), jnp.asarray(v0)), jnp.asarray(table),
        jnp.asarray(starts), jnp.asarray(lengths), has_prefix=True)
    cache = L.PagedKVCache(to_torch(k0), to_torch(v0))
    tout = L.attention_prefill_paged(
        tattn, a, to_torch(x), cache, torch.from_numpy(table),
        torch.from_numpy(starts).long(), torch.from_numpy(lengths).long(),
        has_prefix=True)
    jo = np.asarray(jout.astype(jnp.float32))
    for r in range(B):
        n = lengths[r] - starts[r]
        np.testing.assert_allclose(tout[r, :n].float().numpy(), jo[r, :n],
                                   rtol=0, atol=OUT_ATOL)
    # Every block but the trash block (which takes the unowned lanes, in
    # an order neither package fixes).
    for ours, ref in ((cache.k, jcache.k), (cache.v, jcache.v)):
        ref = np.asarray(ref)[1:]
        got = ours[1:].view(torch.int16).numpy().view(ref.dtype)
        assert _ulps(got, ref).max() <= 1
    # The prefix blocks (below each row's start) are untouched.
    for r in range(B):
        for j in range(starts[r] // bt):
            assert torch.equal(cache.k[table[r, j]], to_torch(k0)[table[r,
                                                                        j]])
    # The same rows without their prefix attend the suffix alone: other
    # outputs wherever a prefix exists.
    alone = L.attention_prefill_paged(
        tattn, a, to_torch(x), L.PagedKVCache(to_torch(k0), to_torch(v0)),
        torch.from_numpy(table), torch.from_numpy(starts).long(),
        torch.from_numpy(lengths).long())
    for r in range(B):
        assert torch.equal(alone[r], tout[r]) == (starts[r] == 0)
