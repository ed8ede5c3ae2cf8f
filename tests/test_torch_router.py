"""The port's router against the reference's on tied probabilities: the
same experts in the same order as ``jax.lax.top_k`` (ties to the lower
index), and a zero hidden row (uniform probabilities) through both
dispatch layouts of ``moe_apply``."""
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

ARCH = "qwen3-moe-30b-a3b"


def _dyadic(rng, shape):
    """Multiples of 1/8 in [-1, 1]: every logit below is an exact float32
    sum, so equal columns give equal logits in both frameworks."""
    return rng.integers(-8, 9, shape).astype(np.float32) / 8


def _tied_inputs(case, E=128, d=32, T=6):
    rng = np.random.default_rng(3)
    w = _dyadic(rng, (d, E))
    x = _dyadic(rng, (T, d))
    if case == "uniform":
        x[1] = 0.0                              # probabilities 1/E each
        x[4] = 0.0
    elif case == "three_maxima":
        # Row 0 reads router row 0 alone: three equal maxima at 5, 9, 12
        # and a runner-up at 3, the rest below.
        x[0] = 0.0
        x[0, 0] = 1.0
        w[0] = rng.uniform(-2.0, 0.0, E).astype(np.float32)
        w[0, [5, 9, 12]] = 3.0
        w[0, 3] = 2.5
        w[0, [20, 40, 60, 80, 100]] = 2.0       # five more equal values
    else:                                       # duplicated router columns
        for dst, src in ((7, 2), (30, 2), (90, 11), (127, 0), (64, 11)):
            w[:, dst] = w[:, src]
    return x, w


@pytest.mark.parametrize("case", ["uniform", "three_maxima",
                                  "duplicated_columns"])
def test_route_breaks_ties_as_the_reference(case):
    x, w = _tied_inputs(case)
    jcfg = jget_config(ARCH).moe
    cfg = get_config(ARCH).moe
    jg, ji, jp = jmoe.route(jnp.asarray(w), jnp.asarray(x), jcfg)
    g, i, p = tmoe.route(torch.from_numpy(w), torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    # The same experts; probabilities from float32 softmaxes of equal
    # logits in two frameworks: a few float32 ulps.
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-9)
    if case == "uniform":
        assert i[1].tolist() == list(range(cfg.top_k))
    if case == "three_maxima":
        assert i[0].tolist() == [5, 9, 12, 3, 20, 40, 60, 80]


@pytest.fixture(scope="module")
def model():
    jcfg = jget_config(ARCH, reduced=True)
    jp = jinit_params(jax.random.PRNGKey(4), jcfg)
    bank = jbuild_bank(jp["blocks"]["0"]["moe"]["experts"], n_hi=0,
                       lo_bits=4)
    router = jax.tree_util.tree_map(lambda a: a[0],
                                    {"router": jp["blocks"]["0"]["moe"]
                                     ["router"]})
    return jcfg, router, jax.tree_util.tree_map(lambda a: a[0], bank), bank


@pytest.mark.parametrize("dispatch", ["ragged", "padded"])
def test_zero_row_routes_as_the_reference(model, dispatch):
    """A zero hidden row has uniform router probabilities: the reference
    sends it to experts 0..k-1. The counts (whole call and per row) and
    the output agree on both dispatch layouts."""
    jcfg, router, jl, bank = model
    cfg = get_config(ARCH, reduced=True)
    T, n_rows = 8, 2
    rng = np.random.default_rng(5)
    x = rng.standard_normal((T, jcfg.d_model)).astype(np.float32)
    x[2] = 0.0
    x = jnp.asarray(x, jnp.bfloat16)
    yj, aj = jmoe.moe_apply(router, jl, x, jcfg.moe, 64, n_rows=n_rows,
                            dispatch=dispatch, gemm="jnp")
    yt, at = tmoe.moe_apply(params_from_reference(
        jax.tree_util.tree_map(np.asarray, router)),
        bank_from_reference(bank).layer(0), to_torch(x), cfg.moe, 64,
        n_rows=n_rows, dispatch=dispatch)
    np.testing.assert_array_equal(np.asarray(aj.counts), at.counts.numpy())
    np.testing.assert_array_equal(np.asarray(aj.row_counts),
                                  at.row_counts.numpy())
    assert at.counts[:cfg.moe.top_k].min() >= 1      # the zero row's set
    want = np.asarray(yj, np.float32)
    # The same group-blocked GEMMs up to the order of their float32 group
    # sums, the same combine order: one bf16 ulp of the largest output.
    np.testing.assert_allclose(yt.float().numpy(), want, rtol=2 ** -7,
                               atol=2 ** -7 * np.abs(want).max())
    assert not yt[2].any()                           # SwiGLU(0) = 0
