"""The port's padded MoE dispatch against the reference's, and against the
port's own ragged dispatch, on one set of converted weights."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.ver import build_bank as jbuild_bank
from repro.models import init_params as jinit_params
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.convert import (bank_from_reference, params_from_reference,
                                 to_torch)
from repro_torch.models import moe as tmoe
from torch_threads import _one_thread  # noqa: F401

ARCH = "qwen3-moe-30b-a3b"


def _bank(experts, hi: bool):
    """A reference bank with experts 1 and 3 published into the two hi
    slots of every layer (``hi``), or with no hi pool at all."""
    if not hi:
        return jbuild_bank(experts, n_hi=0, lo_bits=4)
    bank = jbuild_bank(experts, n_hi=2, lo_bits=4)
    L, E = experts["w_gate"].shape[:2]
    for n in bank.hi:
        for l in range(L):
            for s, e in enumerate((1, 3)):
                bank.hi[n] = bank.hi[n].at[l, s].set(experts[n][l, e])
    bank.slot_owner = jnp.asarray([[1, 3]] * L, jnp.int32)
    sm = np.full((L, E), -1, np.int32)
    sm[:, 1], sm[:, 3] = 0, 1
    bank.slot_map = jnp.asarray(sm)
    return bank


@pytest.fixture(scope="module")
def model():
    jcfg = jget_config(ARCH, reduced=True)
    jp = jinit_params(jax.random.PRNGKey(2), jcfg)
    experts = jp["blocks"]["0"]["moe"]["experts"]
    banks = {hi: _bank(experts, hi) for hi in (False, True)}
    return jcfg, jp, banks


@pytest.mark.parametrize("hi", [False, True], ids=["lo_only", "hi_overlay"])
@pytest.mark.parametrize("T,capacity", [(16, 64), (24, 8)],
                         ids=["drop_free", "drops"])
def test_dispatch_compute_matches_reference(model, hi, T, capacity):
    jcfg, _, banks = model
    E, k, d = jcfg.moe.num_experts, jcfg.moe.top_k, jcfg.d_model
    rng = np.random.default_rng(T + capacity)
    x = jnp.asarray(rng.standard_normal((T, d)), jnp.bfloat16)
    idx = rng.integers(0, E, (T, k)).astype(np.int32)
    idx[3, :] = E                                  # one masked token
    gates = rng.uniform(0.1, 1.0, (T, k)).astype(np.float32)
    gates[idx == E] = 0.0
    jl = jax.tree_util.tree_map(lambda a: a[0], banks[hi])
    # Op by op with the jnp GEMM: the reference's bf16 roundings happen
    # where its source puts them, which the port mirrors.
    yj, cj, dj = jmoe.dispatch_compute(jl, x, jnp.asarray(idx),
                                       jnp.asarray(gates), E, capacity,
                                       gemm="jnp")
    tl = bank_from_reference(banks[hi]).layer(0)
    yt, ct, dt = tmoe.dispatch_compute(tl, to_torch(x),
                                       torch.from_numpy(idx).long(),
                                       torch.from_numpy(gates), E, capacity)
    np.testing.assert_array_equal(np.asarray(cj), ct.numpy())
    assert float(dj) == float(dt)
    if capacity < T:
        assert float(dt) > 0                       # the drop rule ran
    # Same layout and drop rule, the same group-blocked GEMM up to the
    # order of its float32 group sum, the same combine order. Each token
    # sums k bf16 contributions that may differ by one ulp, and they can
    # cancel: one bf16 ulp of the largest output.
    _close(yt, yj)


def _close(yt, yj):
    want = np.asarray(yj, np.float32)
    np.testing.assert_allclose(yt.float().numpy(), want, rtol=2 ** -7,
                               atol=2 ** -7 * np.abs(want).max())


def _moe_inputs(model, T, seed):
    jcfg, jp, _ = model
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((T, jcfg.d_model)), jnp.bfloat16)
    valid = np.ones(T, bool)
    valid[T // 2] = False                          # a vacant row
    router = jax.tree_util.tree_map(lambda a: a[0],
                                    {"router": jp["blocks"]["0"]["moe"]
                                     ["router"]})
    return x, valid, router


@pytest.mark.parametrize("capacity", [32, 8], ids=["drop_free", "drops"])
def test_moe_apply_padded_matches_reference(model, capacity):
    """Routing, counts, drops and the padded layout's gauges against the
    reference's ``moe_apply(dispatch="padded")``."""
    jcfg, _, banks = model
    cfg = get_config(ARCH, reduced=True)
    T, n_rows = 16, 4
    x, valid, router = _moe_inputs(model, T, seed=capacity)
    jl = jax.tree_util.tree_map(lambda a: a[0], banks[True])
    yj, aj = jmoe.moe_apply(router, jl, x, jcfg.moe, capacity,
                            token_valid=jnp.asarray(valid), n_rows=n_rows,
                            dispatch="padded", gemm="jnp")
    yt, at = tmoe.moe_apply(params_from_reference(
        jax.tree_util.tree_map(np.asarray, router)),
        bank_from_reference(banks[True]).layer(0), to_torch(x), cfg.moe,
        capacity, token_valid=torch.from_numpy(valid), n_rows=n_rows,
        dispatch="padded")
    np.testing.assert_array_equal(np.asarray(aj.counts), at.counts.numpy())
    np.testing.assert_array_equal(np.asarray(aj.row_counts),
                                  at.row_counts.numpy())
    assert int(aj.active_experts) == int(at.active_experts)
    assert float(aj.dropped) == float(at.dropped)
    assert float(aj.dispatch_pad_ratio) == pytest.approx(
        float(at.dispatch_pad_ratio), rel=1e-6)
    assert float(aj.aux_loss) == pytest.approx(float(at.aux_loss), rel=1e-5)
    _close(yt, yj)


@pytest.mark.parametrize("capacity", [32, 8], ids=["drop_free", "drops"])
@pytest.mark.parametrize("hi", [False, True], ids=["lo_only", "hi_overlay"])
def test_padded_matches_ragged_per_token(model, capacity, hi):
    """The port's two layouts share the sort, the drop rule and the
    combine; on the CPU their FFNs are the same plain arithmetic (float32
    products, one bf16 rounding), so every token's output is bit-equal."""
    cfg = get_config(ARCH, reduced=True)
    T, n_rows = 16, 4
    x, valid, router = _moe_inputs(model, T, seed=7 + capacity)
    params = params_from_reference(jax.tree_util.tree_map(np.asarray,
                                                          router))
    bank = bank_from_reference(model[2][hi]).layer(0)
    out = {d: tmoe.moe_apply(params, bank, to_torch(x), cfg.moe, capacity,
                             token_valid=torch.from_numpy(valid),
                             n_rows=n_rows, dispatch=d)
           for d in ("padded", "ragged")}
    (yp, ap), (yr, ar) = out["padded"], out["ragged"]
    assert torch.equal(yp, yr)
    assert torch.equal(ap.counts, ar.counts)
    assert torch.equal(ap.row_counts, ar.row_counts)
    assert float(ap.dropped) == float(ar.dropped)
    if capacity == 8:
        assert float(ap.dropped) > 0
    assert not yp[T // 2].any()                    # the vacant row


def test_moe_apply_rejects_unknown_dispatch(model):
    cfg = get_config(ARCH, reduced=True)
    x, _, router = _moe_inputs(model, 8, seed=0)
    with pytest.raises(ValueError, match="dispatch"):
        tmoe.moe_apply(params_from_reference(
            jax.tree_util.tree_map(np.asarray, router)),
            bank_from_reference(model[2][False]).layer(0), to_torch(x),
            cfg.moe, 8, dispatch="dense")
