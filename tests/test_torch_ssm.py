"""The port's Mamba-2 layer (``models/ssm.py``), the dense SwiGLU and the
dense-row sliding-window ring against the reference's, on the reduced
Jamba (d 256, SSD d_state 16, head_dim 32, chunk 16; window 64) with
weights built by ``repro.models.init_params`` and carried over by
``convert``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.models import layers as jlayers
from repro.models import mlp as jmlp
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference, to_torch
from repro_torch.models import layers as tlayers
from repro_torch.models import mlp as tmlp
from repro_torch.models import ssm as tssm
from torch_threads import _one_thread  # noqa: F401

ARCH = "jamba-v0_1-52b"
#: Outputs and conv windows are bf16 values computed from bf16 GEMMs whose
#: partial sums the two libraries round in their own ways (one ulp of an
#: input moves an output by about as much): 2^-6 of the largest magnitude.
REL = 2 ** -6
#: The SSM state is float32, summed from those bf16 inputs over the
#: prompt: the same relative tolerance.


@pytest.fixture(scope="module")
def jamba():
    jcfg = jget_config(ARCH, reduced=True)
    cfg = get_config(ARCH, reduced=True)
    jp = jinit_params(jax.random.PRNGKey(5), jcfg)
    tp = params_from_reference(jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, cfg, jp, tp


def _layer(tree, l=0):
    return jax.tree_util.tree_map(lambda a: a[l], tree)


def _close(got, want, rel=REL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    tol = rel * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, (err, tol)


def test_reduced_config_follows_the_reference_rule(jamba):
    jcfg, cfg, _, _ = jamba
    for f in ("n_layers", "d_model", "d_ff", "superblock", "moe_positions",
              "vocab_size", "max_seq_len"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    for f in ("d_state", "d_conv", "expand", "head_dim", "n_groups",
              "chunk"):
        assert getattr(cfg.ssm, f) == getattr(jcfg.ssm, f), f
    assert cfg.attn.sliding_window == jcfg.attn.sliding_window == 64
    assert cfg.attn.use_rope is False and cfg.moe.norm_topk_prob is False
    full, jfull = get_config(ARCH), jget_config(ARCH)
    assert full.param_count() == jfull.param_count()
    assert full.active_param_count() == jfull.active_param_count()
    assert get_config("jamba-v0.1-52b") == full
    assert cfg.param_count() == jcfg.param_count()


@pytest.mark.parametrize("case", ["whole", "lengths"])
def test_ssd_forward_matches_reference(jamba, case):
    """Chunked SSD over two chunks: outputs at real positions, the final
    state and the conv window; with ``lengths`` a short row, a length-0
    (inert) row and a full one."""
    jcfg, cfg, jp, tp = jamba
    jm = _layer(jp["blocks"]["0"]["mamba"])
    tm = params_from_reference(jax.tree_util.tree_map(np.asarray, jm))
    B, S, d = 3, 2 * cfg.ssm.chunk, cfg.d_model
    x = jnp.asarray(np.random.default_rng(1).standard_normal((B, S, d)),
                    jnp.bfloat16)
    lengths = np.array([20, 0, S]) if case == "lengths" else None
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    jy, jc = jssm.ssd_forward(jm, jcfg.ssm, d, x, lengths=jl)
    ty, tc = tssm.ssd_forward(tm, cfg.ssm, d, to_torch(x),
                              lengths=None if lengths is None
                              else torch.from_numpy(lengths))
    assert ty.dtype == torch.bfloat16 and tc.state.dtype == torch.float32
    assert tc.conv.dtype == torch.bfloat16
    n = lengths if lengths is not None else [S] * B
    for r in range(B):
        if n[r]:
            _close(ty[r, :n[r]], jy[r, :n[r]])
    _close(tc.state, jc.state)
    _close(tc.conv, jc.conv)
    if lengths is not None:
        # The inert row keeps a zero conv window and a zero state.
        assert not tc.conv[1].any() and not tc.state[1].any()


def test_ssd_decode_step_chained_matches_reference(jamba):
    """Prefill, then four decode steps chained on each package's own
    cache; the port's cache is updated in place, and rows outside
    ``row_valid`` keep their state."""
    jcfg, cfg, jp, tp = jamba
    jm = _layer(jp["blocks"]["2"]["mamba"], 0)
    tm = params_from_reference(jax.tree_util.tree_map(np.asarray, jm))
    B, S, d = 2, cfg.ssm.chunk, cfg.d_model
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((B, S, d)), jnp.bfloat16)
    lengths = np.array([9, S])
    _, jc = jssm.ssd_forward(jm, jcfg.ssm, d, x,
                             lengths=jnp.asarray(lengths, jnp.int32))
    _, tc = tssm.ssd_forward(tm, cfg.ssm, d, to_torch(x),
                             lengths=torch.from_numpy(lengths))
    conv_ptr, state_ptr = tc.conv.data_ptr(), tc.state.data_ptr()
    for step in range(4):
        xt = jnp.asarray(rng.standard_normal((B, 1, d)), jnp.bfloat16)
        jy, jc = jssm.ssd_decode_step(jm, jcfg.ssm, d, xt, jc)
        ty = tssm.ssd_decode_step(tm, cfg.ssm, d, to_torch(xt), tc)
        _close(ty, jy)
        _close(tc.state, jc.state)
        _close(tc.conv, jc.conv)
    assert tc.conv.data_ptr() == conv_ptr
    assert tc.state.data_ptr() == state_ptr
    before = (tc.conv.clone(), tc.state.clone())
    xt = torch.from_numpy(rng.standard_normal((B, 1, d))).to(torch.bfloat16)
    tssm.ssd_decode_step(tm, cfg.ssm, d, xt, tc,
                         row_valid=torch.tensor([False, True]))
    assert torch.equal(tc.conv[0], before[0][0])
    assert torch.equal(tc.state[0], before[1][0])
    assert not torch.equal(tc.state[1], before[1][1])


def test_swiglu_matches_reference(jamba):
    """A dense FFN position (position 0's ``mlp``): the reference's casts,
    bf16 products with float32 sums."""
    jcfg, cfg, jp, tp = jamba
    jm = _layer(jp["blocks"]["0"]["mlp"])
    tm = params_from_reference(jax.tree_util.tree_map(np.asarray, jm))
    x = jnp.asarray(np.random.default_rng(3).standard_normal(
        (24, cfg.d_model)), jnp.bfloat16)
    _close(tmlp.swiglu(tm, to_torch(x)), jmlp.swiglu(jm, x))


def test_dense_ring_prefill_then_decode_matches_reference(jamba):
    """Jamba's attention position on dense rows with its window ring
    (capacity min(max_len, 64)): a prompt longer than the ring, a short
    one and an inert row, then decode steps that wrap the ring; no rope
    (``use_rope=False``). K/V rows to one bf16 ulp, outputs to the
    engine tests' tolerance."""
    jcfg, cfg, jp, tp = jamba
    ja = _layer(jp["blocks"]["7"]["attn"])
    ta = params_from_reference(jax.tree_util.tree_map(np.asarray, ja))
    B, S, C = 3, 96, jcfg.attn.sliding_window
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.standard_normal((B, S, cfg.d_model)), jnp.bfloat16)
    lengths = np.array([90, 30, 0])
    jc = jlayers.init_kv_cache(B, C, jcfg.attn)
    tc = tlayers.init_kv_cache((B,), C, cfg.attn, "cpu")
    jo, jc = jlayers.attention_prefill(ja, jcfg.attn, x, jc,
                                       lengths=jnp.asarray(lengths))
    to = tlayers.attention_prefill(ta, cfg.attn, to_torch(x), tc,
                                   torch.from_numpy(lengths))
    for r, n in enumerate(lengths):
        if n:
            np.testing.assert_allclose(to[r, :n].float().numpy(),
                                       np.asarray(jo[r, :n], np.float32),
                                       rtol=0.05, atol=0.05)
    pos = lengths.copy()
    for _ in range(40):
        xt = jnp.asarray(rng.standard_normal((B, 1, cfg.d_model)),
                         jnp.bfloat16)
        jo, jc = jlayers.attention_decode(ja, jcfg.attn, xt,
                                          jnp.asarray(pos, jnp.int32), jc)
        to = tlayers.attention_decode(ta, cfg.attn, to_torch(xt),
                                      torch.from_numpy(pos), tc)
        np.testing.assert_allclose(to[:2].float().numpy(),
                                   np.asarray(jo[:2], np.float32),
                                   rtol=0.05, atol=0.05)
        pos += 1
    for a, b in ((tc.k, jc.k), (tc.v, jc.v)):
        np.testing.assert_allclose(a[:2].float().numpy(),
                                   np.asarray(b[:2], np.float32),
                                   rtol=2 ** -7, atol=2 ** -7)
