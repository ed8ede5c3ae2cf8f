"""Expert parallelism of the port on the CPU: ranks of one gloo group
(``repro_torch.launch.mesh.spawn``, a ``FileStore`` under the test's
temporary directory), each holding its own experts, held to the port's
single-device path bit for bit and to the reference's single-device layer
and engine.

The reference's own expert-parallel engine is not an oracle here: on this
JAX version its engine stops in an explicit-sharding rule
(``ShardingTypeError`` in ``tests/test_expert_parallel.py::
test_ep_engine_token_parity_and_rebalance``); its single-device layer and
engine are.

Four worlds: 8 ranks for the layer (N = 8, and groups of the first 4 and
2 ranks), 4 and 2 ranks for the engine, and the launcher's own 2. What
the ranks run is in ``torch_ep_worker.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import ControllerConfig as JControllerConfig
from repro.core.ver import ExpertBankQ as JExpertBankQ
from repro.core.ver import build_bank as jbuild_bank
from repro.models import init_params as jinit_params
from repro.models import moe as jmoe
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import InferenceEngine as JInferenceEngine
from repro.serving import Request as JRequest
from repro.serving import make_backend as jmake_backend
from repro_torch.convert import params_from_reference, to_torch
from repro_torch.launch import serve
from repro_torch.launch.mesh import spawn
from torch_threads import _one_thread  # noqa: F401

import torch_ep_worker as W

D_MODEL, T = 64, 64
#: Padded regime against the single device: the ranks' partial outputs
#: sum in float32 and round once, the single device adds each token's k
#: contributions in bf16, so a sum may land one bf16 step away: at most
#: 2^-7 of the largest magnitude (the reference's padded psum is held to a
#: tolerance for the same reason).
PADDED_TOL = 2 ** -7


def _bf16_close(got, want):
    """The tolerance the port's layer is held to against the reference's
    ``moe_apply(gemm="jnp")`` (``test_torch_dense_ffn``): the float32
    products run in another summation order than XLA's, so at most 1% of
    the elements differ, each by at most 2^-7 relative (or 2^-7 of the
    largest magnitude)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert np.mean(got != want) <= 0.01
    np.testing.assert_allclose(got, want, rtol=2 ** -7,
                               atol=2 ** -7 * np.abs(want).max())


# -- the layer --------------------------------------------------------------
@pytest.fixture(scope="module")
def layer(tmp_path_factory):
    """The reference's SCRIPT_LAYER weights and bank (hi experts 1 and 6 on
    slots 1 and 6), converted; the reference's single-device ragged
    results; the port's single-device results; and the 8-rank world's."""
    cfg = W.LAYER_CFG
    params = jmoe.init_moe(jax.random.PRNGKey(0), D_MODEL, cfg)
    ew = {k: v[None] for k, v in params["experts"].items()}
    full = jbuild_bank(ew, n_hi=8, lo_bits=4, group_size=32)
    hi = {k: v.at[0, 1].set(ew[k][0, 1].astype(v.dtype))
              .at[0, 6].set(ew[k][0, 6].astype(v.dtype))
          for k, v in full.hi.items()}
    so = np.full((1, 8), -1, np.int32)
    so[0, 1], so[0, 6] = 1, 6
    jbank = JExpertBankQ(lo=full.lo, hi=hi,
                         slot_owner=jnp.asarray(so),
                         slot_map=jnp.asarray(so))
    jl = jax.tree_util.tree_map(lambda a: a[0], jbank)
    x = jax.random.normal(jax.random.PRNGKey(1), (T, D_MODEL), jnp.bfloat16)
    tv = np.arange(T) % 16 != 3
    cap = jmoe.moe_capacity(T, cfg)
    ref = {}
    for case in W.LAYER_CASES:
        use_tv, n_rows, rc = case
        ref[case] = jmoe.moe_apply(
            {"router": params["router"]}, jl, x, cfg, cap,
            token_valid=jnp.asarray(tv) if use_tv else None, n_rows=n_rows,
            row_capacity=rc, dispatch="ragged", gemm="jnp")
    ref["dense"] = jmoe.moe_apply({"router": params["router"]},
                                  dict(params["experts"]), x, cfg, cap,
                                  dispatch="ragged", gemm="jnp")
    setup = {"experts": {k: to_torch(v) for k, v in ew.items()},
             "dense": {k: to_torch(v) for k, v in params["experts"].items()},
             "router": to_torch(params["router"]), "x": to_torch(x),
             "tv": torch.from_numpy(tv)}
    single = W.layer_single(setup)
    ranks = spawn(W.layer_world, 8, "cpu", setup, threads=1,
                  tmpdir=str(tmp_path_factory.mktemp("ep_layer")))
    return ref, single, ranks


def _aux_equal(a, b, n_rows):
    assert torch.equal(a["counts"], b["counts"])
    assert float(a["dropped"]) == float(b["dropped"])
    assert abs(float(a["aux_loss"]) - float(b["aux_loss"])) < 1e-6
    if n_rows:
        assert torch.equal(a["row_counts"], b["row_counts"])
    else:
        assert a["row_counts"] is None and b["row_counts"] is None


@pytest.mark.parametrize("n", W.LAYER_N)
def test_ep_layer_bit_equal_to_single_device(layer, n):
    """The all-to-all regime at N ranks: every rank's y, counts, dropped
    and row_counts equal the single device's bit for bit, aux within 1e-6,
    for {all tokens, token_valid} × {no rows, 16 rows, 16 rows with row
    capacity 2} (the last drops)."""
    _, single, ranks = layer
    dropped = 0
    for case in W.LAYER_CASES:
        y0, a0, _ = single[case]
        for r in range(n):
            y, a, regimes = ranks[r][n][case]
            assert regimes == {"all_to_all": 1, "padded": 0}, (case, r)
            assert torch.equal(y, y0), (case, r)
            _aux_equal(a, a0, case[1])
        dropped += float(a0["dropped"]) > 0
    assert dropped == 2                 # the row-capacity cases drop


@pytest.mark.parametrize("case", W.LAYER_CASES, ids=str)
def test_ep_layer_matches_reference_single_device(layer, case):
    """Rank 0's y at N = 8 against the reference's single-device
    ``moe_apply(dispatch="ragged", gemm="jnp")`` (``_bf16_close``); counts,
    drops and row counts exactly."""
    ref, _, ranks = layer
    yj, aj = ref[case]
    y, a, _ = ranks[0][8][case]
    np.testing.assert_array_equal(np.asarray(aj.counts), a["counts"].numpy())
    assert float(aj.dropped) == float(a["dropped"])
    if case[1]:
        np.testing.assert_array_equal(np.asarray(aj.row_counts),
                                      a["row_counts"].numpy())
    assert abs(float(aj.aux_loss) - float(a["aux_loss"])) < 1e-6
    _bf16_close(y.float().numpy(), yj)


@pytest.mark.parametrize("n", W.LAYER_N)
def test_ep_dense_bank_bit_equal(layer, n):
    """A dense bf16 bank (fp16/offload) under EP: bit-equal to the single
    device's ragged layer (row 7's plain version on each rank's experts),
    which stays within the reference's tolerance."""
    ref, single, ranks = layer
    y0, a0, _ = single["dense"]
    for r in range(n):
        y, a, regimes = ranks[r][n]["dense"]
        assert regimes["all_to_all"] == 1
        assert torch.equal(y, y0)
        _aux_equal(a, a0, None)
    _bf16_close(y0.float().numpy(), ref["dense"][0])


@pytest.mark.parametrize("n", W.LAYER_N)
def test_ep_padded_regime_when_tokens_do_not_divide(layer, n):
    """T = 63 divides over no N: the padded regime runs (the regime
    counter), counts and row counts exact, y within ``PADDED_TOL`` of the
    single device and the same bits on every rank."""
    _, single, ranks = layer
    y0, a0, _ = single["odd"]
    ys = []
    for r in range(n):
        y, a, regimes = ranks[r][n]["odd"]
        assert regimes == {"all_to_all": 0, "padded": 1}
        assert torch.equal(a["counts"], a0["counts"])
        assert torch.equal(a["row_counts"], a0["row_counts"])
        assert abs(float(a["aux_loss"]) - float(a0["aux_loss"])) < 1e-6
        ys.append(y)
    err = float((ys[0].float() - y0.float()).abs().max())
    assert err <= PADDED_TOL * float(y0.float().abs().max()), err
    assert all(torch.equal(y, ys[0]) for y in ys)


# -- engines ----------------------------------------------------------------
@pytest.fixture(scope="module")
def weights():
    jcfg = jget_config(W.ARCH, reduced=True)
    jp = jax.tree_util.tree_map(np.asarray,
                                jinit_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, jp, params_from_reference(jp)


@pytest.fixture(scope="module")
def single(weights):
    """The port's single-device runs the EP runs are held to."""
    tp = weights[2]
    out = {}
    eng, toks = W.serve_engine(tp, "dynaexq", bkw=W.dynaexq_kw(1))
    out["dynaexq"] = W._run(eng, toks)
    for name, backend, bkw, ekw in W.ENGINE_VARIANTS:
        eng, toks = W.serve_engine(tp, backend, bkw=bkw(1), ekw=ekw)
        out[name] = W._run(eng, toks)
    return out


@pytest.fixture(scope="module")
def reference_run(weights):
    """The reference's single-device engine on the same weights and
    requests (dynaexq, n_hi 4, frozen timers): tokens and per-request
    expert counts."""
    jcfg, jp, _ = weights
    be = jmake_backend("dynaexq", n_hi_per_layer=4,
                       controller=JControllerConfig(update_interval_s=1e9))
    eng = JInferenceEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, jp),
                           be, JEngineConfig(**W.ENGINE_CFG))
    hs = [eng.submit(JRequest(tokens=p, max_new_tokens=W.NEW_TOKENS))
          for p in W.engine_prompts(jcfg.vocab_size)]
    eng.drain()
    return ([[int(t) for t in h.tokens] for h in hs],
            [{k: np.asarray(v) for k, v in h.expert_counts.items()}
             for h in hs])


@pytest.fixture(scope="module")
def ep4(weights, tmp_path_factory):
    return spawn(W.engine_world_4, 4, "cpu", weights[2], threads=1,
                 tmpdir=str(tmp_path_factory.mktemp("ep4")))


@pytest.fixture(scope="module")
def ep2(weights, tmp_path_factory):
    return spawn(W.engine_world_2, 2, "cpu", weights[2], threads=1,
                 tmpdir=str(tmp_path_factory.mktemp("ep2")))


def _world(request, n):
    return request.getfixturevalue(f"ep{n}")


def _ranks_agree(ranks, key):
    for r in ranks[1:]:
        assert r[key]["tokens"] == ranks[0][key]["tokens"]
        assert torch.equal(r[key]["logits"], ranks[0][key]["logits"])


@pytest.mark.parametrize("n", [4, 2])
def test_ep_engine_matches_single_device_port(request, single, n):
    """dynaexq served at N ranks (4 requests × 8 tokens, frozen timers):
    tokens and the last step's logits bit-equal to the single-device
    port's on every rank; prefill and decode ran the all-to-all regime."""
    ranks = _world(request, n)
    _ranks_agree(ranks, "dynaexq")
    assert ranks[0]["dynaexq"]["tokens"] == single["dynaexq"]["tokens"]
    assert torch.equal(ranks[0]["dynaexq"]["logits"],
                       single["dynaexq"]["logits"])
    # 1 prefill + 7 decode steps, 2 MoE layers each, all of them EP.
    assert ranks[0]["regimes"] == {"all_to_all": 16, "padded": 0}


def _routing_first(got, want_tokens, want_counts):
    """Tokens equal request by request, except in a request whose routing
    differed from the reference's (a router near tie, after which its
    hidden states legitimately part: the rule of the port's engine tests);
    returns how many requests were equal."""
    same = 0
    for i, (a, b) in enumerate(zip(got["tokens"], want_tokens)):
        if a == b:
            same += 1
            continue
        assert any(not np.array_equal(got["expert_counts"][i][k],
                                      want_counts[i][k])
                   for k in want_counts[i]), i
    return same


@pytest.mark.parametrize("n", [4, 2])
def test_ep_engine_matches_reference_single_device(request, reference_run,
                                                   n):
    """The reference's single-device engine's tokens, under the
    routing-first rule: here one request of four routes one prefill token
    to another expert across the packages (its reference top-2 logit
    margin is 0.02) and differs from its first token; the other three are
    equal."""
    got = _world(request, n)[0]["dynaexq"]
    assert _routing_first(got, *reference_run) >= 3


def test_ep_forced_promotions_land_on_shard_correct_slots(ep4):
    """A forced window at N = 4 (1 hi slot per shard and layer): every
    published expert sits on a slot of its own shard, ``check_invariants``
    passes on every rank, the owning rank's slot holds the expert's host
    rows, and every rank published the same maps."""
    for r in ep4:
        assert r["shard_correct"] and r["hi_rows_landed"]
        assert r["promoted"] > 0
        for k, m in r["slot_maps"].items():
            np.testing.assert_array_equal(m, ep4[0]["slot_maps"][k])


def test_ep_rebalance_moves_an_expert_and_keeps_the_forward(ep2):
    """At N = 2, +100 counts on experts 0 and 1 (shard 0) and a forced
    window: at least one migration, the layer's output bit-equal before
    and after, its counts permuted with the placement, stats counting the
    migration and its bytes, on every rank alike."""
    for r in ep2:
        rb = r["rebalance"]
        assert rb["migrated"] >= 1
        assert not np.array_equal(rb["placement_before"],
                                  rb["placement_after"])
        assert torch.equal(rb["y_before"], rb["y_after"])
        perm = np.argsort(rb["placement_before"][0])[rb["placement_after"][0]]
        np.testing.assert_array_equal(rb["counts_after"].numpy(),
                                      rb["counts_before"].numpy()[perm])
        assert rb["stats"]["migrations"] >= 1
        assert rb["stats"]["bytes_moved"] > 0
        assert torch.equal(rb["y_after"], ep2[0]["rebalance"]["y_after"])


def test_ep_mig_fault_rolls_back(ep2):
    """An ``ep_mig`` fault mid-swap leaves the lo rows, the router and the
    placement bit-equal on both ranks, counts one aborted migration
    (``fault_cancels``) and one ``fault_cancel`` event; one before the swap
    also refunds the window's bytes; the same pair without a fault moves
    and keeps its bytes charged."""
    for r in ep2:
        f = r["ep_mig"]
        for kind in ("corrupt", "fail"):
            assert f[kind]["migrated"] is False
            assert f[kind]["same"] and f[kind]["aborted"] == 1
            assert f[kind]["window_used"] == 0
        assert len(f["fault_cancel_events"]) == 1
        assert f["fault_cancel_events"][0]["site"] == "ep_mig"
        assert f["fault_cancels"] >= 2
        assert f["clean"]["migrated"] and not f["clean"]["same"]
        assert f["clean"]["window_used"] > 0
        # Both directions of the pair's lo rows: the bytes it was charged.
        assert [e["bytes"] for e in f["migration_events"]] == \
            [f["clean"]["window_used"]]


@pytest.mark.parametrize("name", [v[0] for v in W.ENGINE_VARIANTS])
def test_ep_engine_variants_match_single_device(ep2, single, name):
    """At N = 2: dynaexq with ``spec_k=2``, ``static`` on dense rows with
    padded dispatch (the padded regime; held by routing first: a token may
    differ only in a request whose routing already differed, where the
    float32 psum moved a near tie), and ``static``, ``fp16`` and
    ``offload`` on the main path, each against the single-device port;
    every rank alike."""
    _ranks_agree(ep2, name)
    got, want = ep2[0][name], single[name]
    if name != "padded_dense":
        assert got["tokens"] == want["tokens"]
        assert torch.equal(got["logits"], want["logits"])
        assert got["regimes"]["padded"] == 0
        return
    assert got["regimes"]["all_to_all"] == 0 and got["regimes"]["padded"] > 0
    assert _routing_first(got, want["tokens"], want["expert_counts"]) >= 3


LAUNCH = ["--device", "cpu", "--no-spec", "--batch", "4", "--prompt-len",
          "16", "--new-tokens", "4", "--no-obs"]


def test_ep_launcher_serves_rank_zeros_tokens(capsys):
    """``--ep-shards 2`` returns rank 0's tokens, equal to one process's."""
    one = serve.main(LAUNCH + ["--backend", "static"])
    two = serve.main(LAUNCH + ["--backend", "static", "--ep-shards", "2"])
    assert two["tokens"] == one["tokens"]
    assert any("expert parallel: 2 ranks" in ln for ln in two["lines"])


@pytest.mark.parametrize("argv, message", [
    (["--ep-shards", "3"], "num_experts=4 not divisible by ep_shards=3"),
    (["--backend", "dynaexq", "--n-hi", "3", "--ep-shards", "2"],
     "n_hi_per_layer=3 not divisible by ep_shards=2"),
])
def test_ep_launcher_refuses_shapes_that_do_not_divide(argv, message):
    with pytest.raises(SystemExit, match=message):
        serve.main(LAUNCH + argv)
