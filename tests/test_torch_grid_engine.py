"""The port's serving engine over a (data × model) grid on the CPU: every
rank of a gloo grid (``repro_torch.launch.mesh.spawn(..., n_data=2)``)
runs one ``InferenceEngine(..., dist=ctx)`` over the same requests, its
model rank's experts on its device and their bf16 host masters on its
host, replicated over data; held to the port's single-device engine bit
for bit where every MoE call took the all-to-all regime, by routing first
where a padded regime ran, and to the reference's single-device engine.

The reference's own sharded engine is no oracle here (on this JAX
version it stops in an explicit-sharding rule: ``tests/
test_expert_parallel.py::test_ep_engine_token_parity_and_rebalance``);
its single-device engine and its sharded layer's row rule (raised before
any ``shard_map``) are.

Two worlds, one module-scoped ``spawn`` each: a 2 × 2 grid (the main
path, promotions, a rebalance, ``ep_mig`` faults, the variants, a fault
plan, the per-row rule in the engine and under the planner's specs) and
a 2 × 1 grid (the main path, the host tier, the streaming cold start and
a fault plan, which need one shard). What the ranks run is in
``torch_grid_worker.py``."""
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import ControllerConfig as JControllerConfig
from repro.launch.dist import DistContext as JDistContext
from repro.models import init_params as jinit_params
from repro.models import moe as jmoe
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import InferenceEngine as JInferenceEngine
from repro.serving import Request as JRequest
from repro.serving import make_backend as jmake_backend
from repro_torch.convert import params_from_reference
from repro_torch.launch.mesh import spawn
from repro_torch.serving.streaming import save_expert_shards
from torch_threads import _one_thread  # noqa: F401

import torch_ep_worker as EW
import torch_grid_worker as GW

#: bf16 logits under the planner's specs against one process
#: (``test_torch_specs``'s bar for the padded regimes).
SPEC_TOL = 2 ** -6
#: The one-row prefill's tokens: a 24-token prompt in the 32 bucket.
ONE_ROW_T = 32


def _clone(p):
    return {k: _clone(v) for k, v in p.items()} if isinstance(p, dict) \
        else p


@pytest.fixture(scope="module")
def weights():
    jcfg = jget_config(EW.ARCH, reduced=True)
    jp = jax.tree_util.tree_map(np.asarray,
                                jinit_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, jp, params_from_reference(jp)


@pytest.fixture(scope="module")
def shard_dir(weights, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("grid_shards"))
    save_expert_shards(d, _clone(weights[2]), [0], lo_bits=4)
    return d


@pytest.fixture(scope="module")
def single(weights, shard_dir):
    """The port's single-device runs the grids are held to."""
    tp = weights[2]
    out = {}
    eng, toks = EW.serve_engine(tp, "dynaexq", bkw=EW.dynaexq_kw(1))
    out["dynaexq"] = EW._run(eng, toks)
    be = eng.backend
    out["host_master_bytes"] = be.host_master_bytes()
    out["held"] = {k: s.held_rows() for k, s in be.stores.items()}
    be.force_update()
    be.flush()
    out["slot_maps"] = {k: c.tm.slot_map_h.copy()
                        for k, c in be.controllers.items()}
    for name, backend, bkw, ekw in EW.ENGINE_VARIANTS:
        eng, toks = EW.serve_engine(tp, backend, bkw=bkw(1), ekw=ekw)
        out[name] = EW._run(eng, toks)
    out["faulted"] = GW.serve_faulted(tp, None)
    out["tiers"] = GW.serve_tiers(tp, None)
    out["one_row"] = GW.serve_rows(tp, None, dict(prefill_rows=1))
    out["rows_rc"] = GW.serve_rows(tp, None, dict(row_capacity_norm=True))
    out["specs"] = GW.specs_runs(tp, None)
    out["ladder"] = GW.ladder_runs(tp, None, shard_dir)
    return out


@pytest.fixture(scope="module")
def reference_run(weights):
    """The reference's single-device engine (dynaexq, n_hi 4, frozen
    timers): tokens and per-request expert counts."""
    jcfg, jp, _ = weights
    be = jmake_backend("dynaexq", n_hi_per_layer=4,
                       controller=JControllerConfig(update_interval_s=1e9))
    eng = JInferenceEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, jp),
                           be, JEngineConfig(**EW.ENGINE_CFG))
    hs = [eng.submit(JRequest(tokens=p, max_new_tokens=EW.NEW_TOKENS))
          for p in EW.engine_prompts(jcfg.vocab_size)]
    eng.drain()
    return ([[int(t) for t in h.tokens] for h in hs],
            [{k: np.asarray(v) for k, v in h.expert_counts.items()}
             for h in hs])


@pytest.fixture(scope="module")
def grid22(weights, tmp_path_factory):
    return spawn(GW.world_2x2, 2, "cpu", weights[2], n_data=2, threads=1,
                 tmpdir=str(tmp_path_factory.mktemp("grid22")))


@pytest.fixture(scope="module")
def grid21(weights, shard_dir, tmp_path_factory):
    return spawn(GW.world_2x1, 1, "cpu", weights[2], shard_dir, n_data=2,
                 threads=1, tmpdir=str(tmp_path_factory.mktemp("grid21")))


def _grid(request, name):
    return request.getfixturevalue(name)


def _alike(ranks, key):
    for r in ranks[1:]:
        assert r[key]["tokens"] == ranks[0][key]["tokens"], r["coords"]
        assert torch.equal(r[key]["logits"], ranks[0][key]["logits"])


def _same_state(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].keys() == b[k].keys()
        for leaf in a[k]:
            for x, y in zip(a[k][leaf], b[k][leaf]):
                assert torch.equal(x, y), (k, leaf)


def _data_rows_alike(ranks, get):
    """Rank (0, j) and rank (1, j) hold the same state (``get(rank)``)."""
    by = {r["coords"]: r for r in ranks}
    for (i, j), r in by.items():
        if i:
            _same_state(get(by[(0, j)]), get(r))


def _routing_first(got, want_tokens, want_counts):
    """Tokens equal request by request, except in a request whose routing
    differed (a router near tie, after which its hidden states part);
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


@pytest.mark.parametrize("grid", ["grid22", "grid21"])
def test_grid_engine_matches_single_device_port(request, single, grid):
    """dynaexq over the grid (4 requests × 8 tokens, frozen timers): on
    every rank the tokens and the last step's logits bit-equal to the
    single-device port's; every MoE call (1 prefill and 7 decode steps, 2
    layers each) ran the all-to-all regime over data × model."""
    ranks = _grid(request, grid)
    _alike(ranks, "dynaexq")
    assert ranks[0]["dynaexq"]["tokens"] == single["dynaexq"]["tokens"]
    assert torch.equal(ranks[0]["dynaexq"]["logits"],
                       single["dynaexq"]["logits"])
    for r in ranks:
        assert r["regimes"] == {"all_to_all": 0, "padded": 0,
                                "all_to_all_dp": 16}


def test_grid_policy_clocks_start_agreed(grid22):
    """Every rank's policy windows (the controllers', the global
    allocator's, the rebalancer's) count from one agreed reading, so the
    first opens on the same step on every rank of the grid."""
    for r in grid22:
        assert len(r["clocks"]) == 1
        assert r["clocks"] == grid22[0]["clocks"]


def test_store_reads_and_pins_only_owned_experts():
    """A host store owning experts [2, 4) holds and pins their rows only,
    refuses another's and rows of any other shape; a streaming store (one
    shard: every expert) reads an expert's shard when it first loads and
    pins what it read."""
    from repro_torch.serving.hoststore import HostExpertStore
    shapes = {"w": (1, 4, 8, 16)}
    full = torch.arange(4 * 8 * 16, dtype=torch.float32).reshape(
        1, 4, 8, 16).to(torch.bfloat16)
    own = HostExpertStore(shapes, hi={"w": full[:, 2:4].clone()},
                          owned=slice(2, 4))
    assert torch.equal(own["w"][0, 3], full[0, 3])
    assert own.pinned_bytes() == 2 * 8 * 16 * 2
    with pytest.raises(KeyError, match="held by its owner"):
        own["w"][0, 1]
    with pytest.raises(ValueError, match="owned experts"):
        HostExpertStore(shapes, hi={"w": full.clone()}, owned=slice(2, 4))
    reads = []

    def loader(layer, expert):
        reads.append(expert)
        return {"w": full[layer, expert].float().numpy()}

    lazy = HostExpertStore(shapes, hi_loader=loader)
    for e in (3, 1, 3):
        lazy.ensure_hi(0, e)
    assert reads == [3, 1] and lazy.stats["hi_loads"] == 2
    assert lazy.hi_present[0].tolist() == [False, True, False, True]
    assert lazy.pinned_bytes() == 2 * 8 * 16 * 2
    assert torch.equal(lazy["w"][0, 1], full[0, 1])


@pytest.mark.parametrize("grid", ["grid22", "grid21"])
def test_grid_engine_matches_reference_single_device(request,
                                                     reference_run, grid):
    """The reference's single-device engine's tokens under the
    routing-first rule (one request of four routes one prefill token to
    another expert across the packages: ``test_torch_ep``)."""
    got = _grid(request, grid)[0]["dynaexq"]
    assert _routing_first(got, *reference_run) >= 3


def test_grid_forced_promotions_land_on_both_data_rows(grid22, grid21,
                                                       single):
    """A forced window after the rebalance, the relabelled positions made
    hottest: on the 2 × 2 grid they go hi, every published expert sits on
    a slot of its own shard, the owning rank's slot holds its host rows
    and, bit for bit, the weights of the expert its position now carries,
    on both data rows, whose banks, slot maps, routers and placements are
    identical; on the 2 × 1 grid the slot maps are one process's."""
    for r in grid22:
        p = r["promo"]
        assert p["shard_correct"] and p["landed"] and p["promoted"] > 0
        assert p["moved"] > 0 and p["moved_hi"] == p["moved"]
        assert p["slots_hold_weights"]
    _data_rows_alike(grid22, lambda r: r["promo"]["state"])
    _data_rows_alike(grid21, lambda r: r["promo"]["state"])
    for r in grid21:
        for k, m in r["promo"]["slot_maps"].items():
            np.testing.assert_array_equal(m, single["slot_maps"][k])


def test_grid_rebalance_keeps_forward_and_data_rows_alike(grid22,
                                                          weights):
    """+100 counts on experts 0 and 1 (model rank 0) and a forced window
    on the 2 × 2 grid: a migration, the layer's output bit-equal before
    and after, the same on every rank; identical banks, routers and
    placements on both data rows; every host master on its new owner.
    Each model group's exchange over "model" moved the pair's lo rows
    (``bytes_moved``, the reference's price) and their host rows."""
    host_b = sum(t[0, 0].numel() * t.element_size() for t in
                 weights[2]["blocks"]["0"]["moe"]["experts"].values())
    for r in grid22:
        rb = r["rebalance"]
        assert rb["migrated"] >= 1
        assert torch.equal(rb["y_before"], rb["y_after"])
        assert torch.equal(rb["y_after"], grid22[0]["rebalance"]["y_after"])
        assert rb["host_rows_follow"]
    _data_rows_alike(grid22, lambda r: r["rebalance"]["state"])
    for i in (0, 1):
        group = [r for r in grid22 if r["coords"][0] == i]
        sent = sum(r["rebalance"]["sent"]["exchange"]["model"]
                   for r in group)
        rb = group[0]["rebalance"]
        assert sent == rb["lo_bytes"] + 2 * rb["migrated"] * host_b
        assert all(r["rebalance"]["sent"]["exchange"]["data"] == 0
                   for r in group)


def test_grid_ep_mig_fault_rolls_back_on_every_rank(grid22):
    """An ``ep_mig`` fault mid-swap and one before it roll back on all
    four ranks (lo rows, host masters, router, placement), each counted
    once; the same pair without a fault moves on both data rows alike."""
    for r in grid22:
        f = r["ep_mig"]
        for kind in ("corrupt", "fail"):
            assert f[kind]["migrated"] is False
            assert f[kind]["same"] and f[kind]["aborted"] == 1
        assert len(f["fault_cancel_events"]) == 1
        assert f["clean"]["migrated"] and not f["clean"]["same"]
        assert f["host_rows_follow"]
    _data_rows_alike(grid22, lambda r: r["ep_mig"]["state"])


@pytest.mark.parametrize("name", [v[0] for v in EW.ENGINE_VARIANTS])
def test_grid_variants_match_single_device(grid22, single, name):
    """On the 2 × 2 grid: dynaexq with ``spec_k=2``, ``static`` on dense
    rows with padded dispatch (the padded data-split regime, held by
    routing first), and ``static``, ``fp16`` and ``offload`` on the main
    path bit-equal to one process; every rank alike."""
    _alike(grid22, name)
    got, want = grid22[0][name], single[name]
    if name != "padded_dense":
        assert got["tokens"] == want["tokens"]
        assert torch.equal(got["logits"], want["logits"])
        assert set(got["regimes"]) - {"all_to_all", "padded"} == \
            {"all_to_all_dp"}
        assert got["regimes"]["padded"] == got["regimes"]["all_to_all"] == 0
        return
    assert got["regimes"].get("padded_dp", 0) > 0
    assert got["regimes"].get("all_to_all_dp", 0) == 0
    assert _routing_first(got, want["tokens"], want["expert_counts"]) >= 3


def test_grid_fault_plan_cancels_alike_on_every_rank(grid22, single):
    """A promotion fault plan (copies failing, retried, cancelled) on the
    2 × 2 grid: every rank cancels the same promotions as one process
    with the same two shards' books, publishes the same slot maps and
    serves the same tokens and logits."""
    want = single["faulted"]
    assert want["fault_cancels"] > 0 and want["promotions"] > 0
    for r in grid22:
        got = r["faulted"]
        assert got["tokens"] == want["tokens"]
        assert torch.equal(got["logits"], want["logits"])
        for k in ("fault_cancels", "retries", "promotions"):
            assert got[k] == want[k], k
        for k, m in got["slot_maps"].items():
            np.testing.assert_array_equal(m, want["slot_maps"][k])


def test_grid_batch_tier_and_preemption_match_single_device(grid22,
                                                            single):
    """Every expert hi, two batch-tier requests decoding on the all-lo
    view beside two standard ones, one of those preempted and resumed:
    on every rank of the 2 × 2 grid one process's tokens and last logits
    bit for bit, every MoE call all-to-all over data × model."""
    _alike(grid22, "tiers")
    got, want = grid22[0]["tiers"], single["tiers"]
    assert want["hi"] > 0 and want["preemptions"] == want["resumes"] == 1
    assert got["tokens"] == want["tokens"]
    assert torch.equal(got["logits"], want["logits"])
    for k in ("preemptions", "resumes", "hi"):
        assert got[k] == want[k], k
    assert {k for k, v in got["regimes"].items() if v} == {"all_to_all_dp"}


def test_grid_one_row_prefill_without_the_row_rule(grid22, single):
    """``prefill_rows=1`` on the 2 × 2 grid: one row does not tile over
    the 4 token shards, so each prefill runs the padded data-split regime
    (its float32 sum over model: held by routing first), each decode
    step the all-to-all one; every rank alike. As in the reference, that
    regime gives no per-row counts where the rows do not tile over data:
    the prefill's counts are (nsb, E) totals, and the requests'
    ``expert_counts`` stay empty (the reference's engine attributes only
    row-resolved counts, and only to the layers its prefill attributed).
    Each request's routing over its forwards is one process's where its
    tokens are."""
    _alike(grid22, "one_row")
    got = grid22[0]["one_row"]
    assert got["regimes"]["padded_dp"] == 2 * 4
    assert got["regimes"]["all_to_all_dp"] == 2 * (EW.NEW_TOKENS - 1)
    want = single["one_row"]
    assert got["count_ndims"] == [2, 3] and want["count_ndims"] == [3]
    assert all(c == {} for c in got["expert_counts"])
    for a, b in zip(want["routed"], want["expert_counts"]):
        assert a.keys() == b.keys()
        assert all(np.array_equal(a[k], b[k]) for k in b)
    agree = sum(all(np.array_equal(a[k], b[k]) for k in b)
                for a, b in zip(got["routed"], want["routed"]))
    assert agree >= 3
    assert _routing_first(dict(got, expert_counts=got["routed"]),
                          want["tokens"], want["routed"]) >= 3


def test_grid_one_row_prefill_with_the_row_rule_raises_as_the_reference(
        grid22, weights):
    """``prefill_rows=1`` with ``row_capacity_norm`` on the 2 × 2 grid: the
    padded regime cannot keep the row on one data shard, and every rank
    raises the ``ValueError`` the reference's sharded layer raises for the
    same tokens and rows (its rule runs before any ``shard_map``)."""
    errs = {r["one_row_rc"].get("error") for r in grid22}
    assert len(errs) == 1
    err = errs.pop()
    assert err is not None
    jcfg = weights[0]
    jp = weights[1]["blocks"]["0"]["moe"]
    stub = types.SimpleNamespace(shape={"data": 2, "model": 2})
    jctx = JDistContext(mesh=stub, dp_axes=("data",), tokens_ep_sharded=True)
    x = jnp.zeros((ONE_ROW_T, jcfg.d_model), jnp.bfloat16)
    layer = {k: jnp.asarray(v[0]) for k, v in jp["experts"].items()}
    with pytest.raises(ValueError) as want:
        jmoe._moe_apply_sharded({"router": jnp.asarray(jp["router"][0])},
                                layer, x, jcfg.moe,
                                jmoe.moe_capacity(ONE_ROW_T, jcfg.moe), jctx,
                                n_rows=1, row_capacity=4, dispatch="ragged")
    assert str(want.value) == err
    assert re.search(r"tile over the 2 data shards \(T=32, n_rows=1\)", err)


def test_grid_row_rule_serves_where_rows_tile(grid22, single):
    """``row_capacity_norm`` with 4-row prefills: the rows tile over the 4
    token shards, every call takes the all-to-all regime, and the tokens
    and logits are one process's bit for bit on every rank."""
    _alike(grid22, "rows_rc")
    got, want = grid22[0]["rows_rc"], single["rows_rc"]
    assert "error" not in got
    assert got["regimes"]["all_to_all_dp"] == 16
    assert got["tokens"] == want["tokens"]
    assert torch.equal(got["logits"], want["logits"])


def test_host_masters_cut_to_owners(grid22, grid21, single, weights):
    """Each rank pins only its own experts' bf16 masters: on the 2 × 2
    grid half of one process's bytes (every rank alike, the same expert
    device bytes on both data rows), on the 2 × 1 grid all of them; one
    process holds every expert's rows, ``params``' bit for bit; the
    backends without masters hold none."""
    full = single["host_master_bytes"]
    experts = weights[2]["blocks"]["0"]["moe"]["experts"]
    assert full == sum(t.numel() * t.element_size()
                       for t in experts.values())
    for name, t in single["held"]["0"].items():
        assert torch.equal(t, experts[name])
    for r in grid22:
        assert r["host_master_bytes"] * 2 == full
        for name in ("static", "fp16", "offload"):
            assert r[name]["host_master_bytes"] == 0
    by = {r["coords"]: r["device_bytes"] for r in grid22}
    assert by[(0, 0)] == by[(1, 0)] and by[(0, 1)] == by[(1, 1)]
    for r in grid21:
        assert r["host_master_bytes"] == full


@pytest.mark.parametrize("name", list(GW.LADDER_RUNS))
def test_grid_ladder_matches_single_device(grid21, single, name):
    """On the 2 × 1 grid: the host tier, the streaming cold start and the
    cold start under a fault plan (with the host tier), each over two
    batches with a forced window between, serve one process's tokens and
    logits, with its ladder stats (host fetches, retries, quarantines, hi
    loads) and shard bytes read before serving opened; every rank
    alike."""
    want = single["ladder"][name]
    for r in grid21:
        got = r["ladder"][name]
        assert got["tokens"] == want["tokens"]
        assert torch.equal(got["logits"], want["logits"])
        assert got["stats"] == want["stats"]
        assert got["ready_read"] == want["ready_read"]
        assert got["mix"] == want["mix"]
    if name == "stream_faults":
        assert want["stats"]["retries"] > 0
    if name != "host_tier":
        assert want["ready_read"] > 0
    else:
        assert want["stats"]["host_fetches"] > 0


@pytest.mark.parametrize("dispatch", [c[0] for c in GW.SPEC_CASES])
def test_specs_row_capacity_matches_one_process(grid22, single, dispatch):
    """``prefill`` and 4 decode steps with ``row_capacity`` 1 under the
    planner's specs on the 2 × 2 grid (4 rows: each data row's 2 over the
    padded regime, or the all-to-all one over model): per-row counts
    exactly one process's, logits within ``SPEC_TOL``; the rule drops."""
    want = single["specs"][dispatch]
    for r in grid22:
        got = r["specs"][dispatch]
        g = got["group"]
        for a, b in zip(got["counts"], want["counts"]):
            for k in b:
                assert torch.equal(a[k], b[k][:, g]), k
        for a, b in zip([got["prefill"]] + got["decode"],
                        [want["prefill"]] + want["decode"]):
            bg = b[g]
            assert float((a - bg).abs().max()) <= SPEC_TOL * float(
                bg.abs().max())
    regime = "padded" if dispatch == "padded" else "all_to_all"
    assert grid22[0]["specs"][dispatch]["regimes"][regime] > 0
