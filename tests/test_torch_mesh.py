"""The mesh's data axis on the CPU: the sharding planner against the
reference's, and the MoE layer's data-axis regimes and sequence-parallel
attention on (data × model) gloo grids (``repro_torch.launch.mesh.spawn``)
against the port's single-device path and the reference's single-device
functions.

The reference's own sharded path is no oracle here: on this JAX version
``tests/test_distributed.py::test_shard_map_moe_matches_single_device``
stops before its comparison. Its single-device ``prefill``,
``decode_step``, ``forward_train`` and ``moe_apply`` are.

One world of 4 ranks (a 2 × 2 grid, and a 1 × 3 grid over ranks 0-2);
what the ranks run is in ``torch_mesh_worker.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro.core.ver import build_bank as jbuild_bank
from repro.launch.sharding import ShardingPlanner as JPlanner
from repro.models import decode_step as jdecode_step
from repro.models import forward_train as jforward_train
from repro.models import init_caches as jinit_caches
from repro.models import init_params as jinit_params
from repro.models import prefill as jprefill
from repro_torch.configs import get_config
from repro_torch.convert import bank_from_reference, params_from_reference
from repro_torch.core.ver import build_bank
from repro_torch.launch import sharding as S
from repro_torch.launch.dist import DistContext, ep_context
from repro_torch.launch import mesh
from repro_torch.launch.mesh import spawn
from repro_torch.models import moe as M
from repro_torch.models.model import init_caches, init_params
from torch_threads import _one_thread  # noqa: F401

import torch_mesh_worker as W

#: The reference's bar for its sharded forward against one device
#: (``tests/test_distributed.py``): 1e-4 of the largest |logit|.
REL_TOL = 1e-4
#: The padded regimes against one device in bf16: each rank adds its
#: experts' share of a token's top-k contributions in bf16 and the model
#: axis sums the partial outputs in float32, rounded once, where one
#: device adds all k in bf16 — a layer output may land one bf16 step
#: (2^-7 of the largest magnitude) away (``test_torch_ep.PADDED_TOL``).
PADDED_TOL = 2 ** -7
#: The port's bf16 logits against the reference's, and only those
#: (``test_torch_model.LOGIT_ATOL``: the decode attention's float32
#: arithmetic and rope's sin/cos move hidden states by a few bf16 ulps).
LOGIT_ATOL = 0.1


class StandInMesh:
    """What the reference's planner reads of a mesh: ``.shape`` and
    ``.axis_names``."""

    def __init__(self, shape, names):
        self.shape = dict(zip(names, shape))
        self.axis_names = tuple(names)


MESHES = (((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 2), ("data", "model")))


def _ref_leaves(tree):
    return [(jax.tree_util.keystr(kp), tuple(leaf.shape)) for kp, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def _abstract(cfg, batch, max_len):
    """The reference's abstract param and cache trees of ``cfg`` (no
    allocation)."""
    params = jax.eval_shape(lambda: jinit_params(jax.random.PRNGKey(0), cfg))
    caches = jax.eval_shape(lambda: jinit_caches(cfg, batch, max_len))
    return _ref_leaves(params), _ref_leaves(caches)


INPUTS = (("tokens", (32, 4096)), ("token", (256,)), ("token", (1,)),
          ("tokens", (1, 32768)), ("pos", ()), ("lengths", (8,)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_planner_matches_reference(arch):
    """Every leaf of the full config's abstract param and cache trees,
    and a few inputs, at meshes (16, 16), (2, 16, 16) and (2, 2) with and
    without FSDP: the port's spec equals the reference's PartitionSpec
    entry for entry, and the notes are the same list."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    params, caches = _abstract(jcfg, 8, 256)
    n = 0
    for shape, names in MESHES:
        mesh = StandInMesh(shape, names)
        for fsdp in (False, True):
            ref = JPlanner(jcfg, mesh, fsdp=fsdp)
            port = S.ShardingPlanner(cfg, S.GridShape(mesh.shape,
                                                      mesh.axis_names),
                                     fsdp=fsdp)
            for kind, leaves in (("param", params), ("cache", caches),
                                 ("input", INPUTS)):
                rf = getattr(ref, f"spec_for_{kind}")
                pf = getattr(port, f"spec_for_{kind}")
                for path, shp in leaves:
                    assert pf(path, shp) == tuple(rf(path, shp)), \
                        (kind, path, shp, shape, fsdp)
                    n += 1
            assert port.notes == ref.notes, (shape, fsdp)
    assert n > 0


def _port_trees(arch):
    cfg = get_config(arch, reduced=True)
    params = init_params(cfg, device="cpu")
    caches = init_caches(cfg, 2, 64, device="cpu")
    return cfg, params, caches


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_planner_paths_match_reference(arch):
    """The reduced config's param and cache trees of the port, walked by
    ``leaf_paths``, name every leaf as the reference's ``keystr`` names it
    in its own trees, at the same shape (so a leaf gets the same
    placement); a quantized bank's leaves too, where the stack has MoE;
    and ``tree_specs`` gives the reference's specs at (2, 2)."""
    jcfg = jget_config(arch, reduced=True)
    cfg, params, caches = _port_trees(arch)
    ref_p, ref_c = _abstract(jcfg, 2, 64)
    got_p = {p: tuple(t.shape) for p, t in S.leaf_paths(params)}
    got_c = {p: tuple(t.shape) for p, t in S.leaf_paths(caches, caches=True)
             if not p.startswith(".cross['valid']")}
    assert got_p == dict(ref_p)
    assert got_c == dict(ref_c)
    mesh = StandInMesh((2, 2), ("data", "model"))
    ref = JPlanner(jcfg, mesh, fsdp=True)
    port = S.ShardingPlanner(cfg, S.GridShape(mesh.shape, mesh.axis_names),
                             fsdp=True)
    specs = port.tree_specs(params, "param")
    assert specs == {p: tuple(ref.spec_for_param(p, s)) for p, s in ref_p}
    moe = [bp["moe"]["experts"] for bp in params["blocks"].values()
           if "moe" in bp]
    if moe:
        bank = build_bank(moe[0], n_hi=2, lo_bits=4, group_size=32)
        jb = jax.eval_shape(lambda: jbuild_bank(
            {k: jnp.zeros(v.shape, jnp.bfloat16) for k, v in moe[0].items()},
            n_hi=2, lo_bits=4, group_size=32))
        assert {p: tuple(t.shape) for p, t in S.leaf_paths(bank)} == \
            dict(_ref_leaves(jb))
        assert port.tree_specs(bank, "param") == {
            p: tuple(ref.spec_for_param(p, s)) for p, s in _ref_leaves(jb)}


def test_context_device_defaults_to_the_card():
    """A context built with no device is on the card, or raises as
    ``resolve_device`` does where there is none; asked for, the CPU."""
    if torch.cuda.is_available():
        assert DistContext(None, 0, 1).device.type == "cuda"
        assert ep_context(None, 0, 1).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DistContext(None, 0, 1)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ep_context(None, 0, 1)
    assert ep_context(None, 0, 1, "cpu").device == torch.device("cpu")


# -- the grid ---------------------------------------------------------------
def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.float() if tree is not None and tree.is_floating_point() \
        else tree


def _jf32(tree):
    return jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32)
        if hasattr(x, "dtype") and x.dtype == jnp.bfloat16 else x, tree)


def _jbank(experts):
    """The reference's stacked bank with ``W.HI_OWNERS`` published."""
    bank = jbuild_bank(experts, n_hi=2, lo_bits=4, group_size=32)
    L, E = experts["w_gate"].shape[:2]
    for n in bank.hi:
        for s, e in W.HI_OWNERS:
            bank.hi[n] = bank.hi[n].at[:, s].set(experts[n][:, e])
    so = np.full((L, 2), -1, np.int32)
    sm = np.full((L, E), -1, np.int32)
    for s, e in W.HI_OWNERS:
        so[:, s], sm[:, e] = e, s
    bank.slot_owner, bank.slot_map = jnp.asarray(so), jnp.asarray(sm)
    return bank


@pytest.fixture(scope="module")
def weights():
    """Reference params (numpy), their port twins in bf16 and float32,
    the reference bank and its port twin, and the sequence-parallel
    stack's (E = 6)."""
    jcfg = jget_config(W.ARCH, reduced=True)
    jp = jax.tree_util.tree_map(np.asarray,
                                jinit_params(jax.random.PRNGKey(0), jcfg))
    jbank = _jbank(jax.tree_util.tree_map(
        jnp.asarray, jp["blocks"]["0"]["moe"]["experts"]))
    jcfg6 = jget_config(W.ARCH).reduced(num_experts=6)
    jp6 = jax.tree_util.tree_map(np.asarray,
                                 jinit_params(jax.random.PRNGKey(6), jcfg6))
    return jcfg, jp, jbank, jcfg6, jp6


@pytest.fixture(scope="module")
def setup(weights):
    jcfg, jp, jbank, jcfg6, jp6 = weights
    rng = np.random.default_rng(30)
    tp = params_from_reference(jp)
    bank = bank_from_reference(jbank)
    layer = bank.layer(0)
    bank = {"0": bank}
    x = torch.from_numpy(rng.standard_normal((W.LAYER_T, jcfg.d_model))
                         .astype(np.float32)).to(torch.bfloat16)
    return {
        "cfg": get_config(W.ARCH, reduced=True), "params": tp,
        "params32": _f32(tp), "bank": bank,
        "bank_layer": dataclasses.replace(
            layer, lo={n: dataclasses.replace(q, packed=q.packed.clone(),
                                              scales=q.scales.clone())
                       for n, q in layer.lo.items()},
            hi={n: h.clone() for n, h in layer.hi.items()},
            slot_owner=layer.slot_owner.clone(),
            slot_map=layer.slot_map.clone()),
        "router": tp["blocks"]["0"]["moe"]["router"][0].clone(),
        "tokens": torch.from_numpy(rng.integers(
            1, jcfg.vocab_size, (W.B, W.S + 1))),
        "x": x, "tv": torch.from_numpy(np.arange(W.LAYER_T) % 16 != 3),
        "sp_cfg6": get_config(W.ARCH).reduced(num_experts=6),
        "sp_params6": _f32(params_from_reference(jp6)),
        "sp_tokens": torch.from_numpy(rng.integers(
            1, jcfg.vocab_size, (W.SP_B, W.SP_S + 1))),
    }


@pytest.fixture(scope="module")
def single(setup):
    """The port's single-device runs the grid is held to."""
    cfg, t = setup["cfg"], setup["tokens"]
    out = {"a": W.model_run(cfg, setup["params32"], t, None),
           "padded": W.model_run(cfg, setup["params"], t, None,
                                 bank=setup["bank"]),
           "ragged": W.model_run(cfg, setup["params"], t, None,
                                 bank=setup["bank"], dispatch="ragged"),
           "ragged_dense": W.model_run(cfg, setup["params"], t, None,
                                       dispatch="ragged"),
           "layer": W.layer_runs(setup, None, setup["bank_layer"]),
           "sp6": W.sp_run(setup["sp_cfg6"], setup["sp_params6"],
                           setup["sp_tokens"], None),
           "sp4": W.sp_run(cfg, setup["params32"], setup["sp_tokens"], None)}
    with torch.no_grad():
        y, aux = M.moe_apply({"router": setup["router"]},
                             setup["bank_layer"], setup["x"], W.LAYER_CFG,
                             M.moe_capacity(W.LAYER_T, W.LAYER_CFG),
                             token_valid=setup["tv"], n_rows=16)
    out["fallback"] = {"y": y, "aux": aux._asdict()}
    return out


@pytest.fixture(scope="module")
def reference(weights, setup):
    """The reference's single-device prefill/decode_step/forward_train on
    the same weights: float32 with dense experts (its distributed test's
    setup), bf16 on the bank, and the sequence-parallel stacks'
    forward_train in float32."""
    jcfg, jp, jbank, jcfg6, jp6 = weights
    toks = jnp.asarray(setup["tokens"].numpy(), jnp.int32)
    batch = {"tokens": toks[:, :W.S]}
    out = {}
    p32 = _jf32(jax.tree_util.tree_map(jnp.asarray, jp))
    lg, _, counts = jprefill(p32, jcfg, batch,
                             _jf32(jinit_caches(jcfg, W.B, W.MAX_LEN)),
                             capacity_factor=W.CF)
    lt, _ = jforward_train(p32, jcfg, batch, capacity_factor=W.CF,
                           remat=False)
    out["a"] = {"prefill": np.asarray(lg), "train": np.asarray(lt),
                "counts": np.asarray(counts["0"])}
    pj = jax.tree_util.tree_map(jnp.asarray, jp)
    for disp in ("padded", "ragged"):
        lg, caches, counts = jprefill(
            pj, jcfg, batch, jinit_caches(jcfg, W.B, W.MAX_LEN),
            bank={"0": jbank}, capacity_factor=W.CF, moe_dispatch=disp)
        lg2, _, c2 = jdecode_step(pj, jcfg, toks[:, W.S], jnp.int32(W.S),
                                  caches, bank={"0": jbank},
                                  capacity_factor=W.CF, moe_dispatch=disp)
        out[disp] = {"prefill": np.asarray(lg), "decode": np.asarray(lg2),
                     "counts": np.asarray(counts["0"]),
                     "counts2": np.asarray(c2["0"])}
    st = jnp.asarray(setup["sp_tokens"].numpy(), jnp.int32)[:, :-1]
    for name, cfg, p in (("sp6", jcfg6, jp6), ("sp4", jcfg, jp)):
        lt, _ = jforward_train(_jf32(jax.tree_util.tree_map(jnp.asarray, p)),
                               cfg, {"tokens": st}, capacity_factor=W.CF,
                               remat=False)
        out[name] = np.asarray(lt)
    return out


@pytest.fixture(scope="module")
def grid(setup, tmp_path_factory):
    return spawn(W.grid_world, 2, "cpu", setup, n_data=2, threads=1,
                 tmpdir=str(tmp_path_factory.mktemp("mesh")))


def _close(got, want, tol=REL_TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1.0), err


def test_grid_layout_is_data_major(grid):
    """Rank r of the 2 × 2 grid sits at (r // 2, r % 2)."""
    assert [r["coords"] for r in grid] == [(0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("key", ["prefill", "train"])
def test_regime_a_float32_matches_single_device_and_reference(
        grid, single, reference, key):
    """Tokens split over data, experts over model (float32, dense
    experts, the reference's distributed test): every rank's prefill
    logits and teacher-forced forward_train logits within 1e-4 of the
    largest |logit| of the port's single device and of the reference's,
    counts equal; the padded data-split regime ran in every MoE call."""
    for r in grid:
        got = r["a"]
        assert got["regimes"] == {"all_to_all": 0, "padded": 0,
                                  "padded_dp": 2 * 2}
        _close(got[key], single["a"][key])
        _close(got[key], reference["a"][key])
        assert torch.equal(got["counts"]["0"], single["a"]["counts"]["0"])
        np.testing.assert_array_equal(got["counts"]["0"].numpy(),
                                      reference["a"]["counts"])


def _bf16_padded(got, want):
    """The padded regimes' logits against the single device's: counts
    equal, prefill and decode logits within ``REL_TOL`` of the largest
    |logit| (the reference's bar). At top-2 over two model shards a
    token's two contributions add once either way (in bf16 on one shard,
    or in float32 rounded once across shards), and an FF slice keeps
    every output's dot product whole, so the bf16 runs land on the single
    device's bits."""
    for k in ("counts", "counts2"):
        assert torch.equal(got[k]["0"], want[k]["0"]), k
    for k in ("prefill", "decode"):
        _close(got[k], want[k])


def test_regime_a_bank_matches_single_device(grid, single):
    """Regime (a) on the quantized bank (bf16, hi slots published):
    prefill and decode under the grid against the single device's padded
    dispatch; every rank the same bits."""
    for r in grid:
        assert r["a_bank"]["regimes"]["padded_dp"] == 2 * 2
        _bf16_padded(r["a_bank"], single["padded"])
        assert torch.equal(r["a_bank"]["decode"], grid[0]["a_bank"]["decode"])


def test_regime_a_layer_rows(grid, single):
    """The padded data-split layer on 64 tokens: y within ``PADDED_TOL``
    of one device, counts, row counts (16 rows: 8 per data rank) and
    dropped exact; rows that do not tile over data give no row counts,
    and with a row capacity raise."""
    for r in grid:
        for name in ("all", "rows"):
            y, a, regimes = r["a_layer"][name]
            y0, a0, _ = single["layer"][name]
            assert regimes["padded_dp"] == 1
            err = float((y.float() - y0.float()).abs().max())
            assert err <= PADDED_TOL * float(y0.float().abs().max()), err
            assert torch.equal(a["counts"], a0["counts"])
            assert float(a["dropped"]) == float(a0["dropped"])
            if name == "rows":
                assert torch.equal(a["row_counts"], a0["row_counts"])
        assert r["a_layer"]["untiled_rows"] is None
        assert "tile over the 2 data shards" in \
            r["a_layer"]["untiled_row_capacity"]


def test_regime_b_ff_sliced_matches_single_device(grid, single):
    """Tokens replicated over data, the experts' FF dims sliced over it:
    the FF-sliced regime ran in every MoE call, prefill and decode within
    the padded regimes' bar of one device; every rank the same bits."""
    for r in grid:
        assert r["b"]["regimes"]["padded_ff"] == 2 * 2
        _bf16_padded(r["b"], single["padded"])
        assert torch.equal(r["b"]["decode"], grid[0]["b"]["decode"])


def test_regime_b_ranks_hold_a_quarter_of_the_bank(grid):
    """(b)'s ranks each hold 1/4 of one process's expert bytes (E/2
    experts, F/2 and D/2 columns); (a)'s 1/2."""
    for r in grid:
        b = r["bytes"]
        assert 4 * b["b"] == b["full"] and 2 * b["a"] == b["full"]


@pytest.mark.parametrize("run, against", [("c", "ragged"),
                                          ("c_dense", "ragged_dense")])
def test_regime_c_bit_equal_to_single_device(grid, single, run, against):
    """The all-to-all over data × model, on the quantized bank and on the
    dense bf16 experts (fp16 serving: row 7's plain version): every
    rank's prefill and decode logits and counts bit-equal to the single
    device's ragged dispatch; every MoE call ran it."""
    want = single[against]
    for r in grid:
        got = r[run]
        assert got["regimes"] == {"all_to_all": 0, "padded": 0,
                                  "all_to_all_dp": 2 * 2}
        for k in ("prefill", "decode"):
            assert torch.equal(got[k], want[k]), k
        for k in ("counts", "counts2"):
            assert torch.equal(got[k]["0"], want[k]["0"]), k


@pytest.mark.parametrize("disp", ["ragged", "padded"])
def test_single_device_bank_matches_reference(single, reference, disp):
    """The single device the grid is held to, against the reference's
    single device on the same bank: logits within ``LOGIT_ATOL``, counts
    equal."""
    got, want = single[disp], reference[disp]
    for k in ("prefill", "decode"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=LOGIT_ATOL)
    np.testing.assert_array_equal(got["counts"]["0"].numpy(), want["counts"])
    np.testing.assert_array_equal(got["counts2"]["0"].numpy(),
                                  want["counts2"])


def test_regime_c_sent_bytes(grid):
    """One decode-shaped layer call of (c) (4 tokens, one per rank): the
    all-to-all sent 2·(N−1)·S·d bf16 payload bytes and (N−1)·E/N int64
    counts over the model axis only; the y all-gather (T/4)·d·2·3 bytes
    and the stats all-reduce a ring's share of (E+3) float64 over the
    token axes; nothing over the data axis alone."""
    cfg = W.LAYER_CFG
    d, E, n, n_tok = 256, cfg.num_experts, 2, 4
    S_rows = M.ep_payload_rows(W.B, cfg.top_k, E // n,
                               M.moe_capacity(W.B, cfg), n_tok)
    for r in grid:
        sent = r["c_sent"]
        assert sent["all_to_all"] == {
            "model": 2 * (n - 1) * S_rows * d * 2 + (n - 1) * (E // n) * 8,
            "data": 0, "tokens": 0}
        assert sent["all_gather"] == {"model": 0, "data": 0,
                                      "tokens": W.B // n_tok * d * 2 * 3}
        assert sent["all_reduce"] == {
            "model": 0, "data": 0,
            "tokens": (E + 3) * 8 * 2 * (n_tok - 1) // n_tok}


@pytest.mark.parametrize("name", ["sp6", "sp4"])
def test_seq_parallel_forward_train(grid, single, reference, name):
    """A 1 × 3 grid over 4 heads: every attention layer ran
    sequence-parallel; forward_train's logits within 1e-4 of the largest
    |logit| of the port's single device and of the reference's, its loss
    within 1e-5 of one process's, counts equal. E = 6 runs the padded
    regime over the model axis, E = 4 the whole-bank fallback."""
    for r in grid[:3]:
        got = r[name]
        assert got["seq_parallel"] == 2 * 2      # forward_train, loss_fn
        regime = "padded" if name == "sp6" else "replicated"
        assert got["regimes"].get(regime, 0) == 2 * 2
        _close(got["logits"], single[name]["logits"])
        _close(got["logits"], reference[name])
        assert abs(float(got["loss"]) - float(single[name]["loss"])) <= \
            1e-5 * abs(float(single[name]["loss"]))
        for k in got["counts"]:
            assert torch.equal(got["counts"][k], single[name]["counts"][k])
    assert "sp6" not in grid[3]


def test_whole_bank_fallback_bit_equal(grid, single):
    """E = 4 over a model axis of 3: each rank holding the whole bank runs
    the single-device layer (y and every MoEAux field bit-equal to one
    process's); a rank holding a shard of such a bank raises."""
    want = single["fallback"]
    for r in grid[:3]:
        f = r["fallback"]
        assert f["regimes"] == {"all_to_all": 0, "padded": 0,
                                "replicated": 1}
        assert torch.equal(f["y"], want["y"])
        for k, v in want["aux"].items():
            assert torch.equal(f["aux"][k], v), k
        assert "not divisible by 3 shards" in f["shard_error"]


def test_grid_ranks_must_ascend(monkeypatch):
    """A grid over ranks out of ascending order is refused before any
    group is made: ``new_group`` numbers its members in ascending order,
    so a rank's place in the list would not be its rank in the groups."""
    monkeypatch.setattr(mesh.tdist, "get_world_size", lambda: 4)
    with pytest.raises(ValueError, match="not in ascending order"):
        mesh.grid_context(2, 2, ranks=[2, 0, 1, 3], device="cpu")
