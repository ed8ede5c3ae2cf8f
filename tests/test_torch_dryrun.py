"""The dry run on the CPU (``repro_torch.launch.dryrun``, ``launch.shapes``,
the production grids and the recording mode of ``launch.dist``):

* the shapes, skips, window, assigned archs and per-shape configs equal
  the reference's ``launch/shapes.py`` and ``launch/dryrun.py``;
* every rank's bytes of params, bank, caches, inputs and AdamW state
  equal, to the byte, those the reference planner's specs give over the
  reference's own abstract trees (``jax.eval_shape``), on 16 × 16 and
  2 × 16 × 16;
* the recording mode's ``SENT_BYTES`` equal a real gloo run's on a 2 × 2
  grid, for every collective and for prefill, decode and the FSDP train
  step; a ``meta`` tensor outside the dry run raises;
* a full-depth record allocates nothing off ``meta``;
* the command line's lines: OK for every family (the decoder-only
  attention stacks, Mamba-2, Jamba, Whisper, LLaVA), SKIP for Whisper's
  500k decode, exit code 1 on a failed cell.

The reference's own dry-run test (``tests/test_distributed.py::
test_dryrun_machinery_small_multipod_mesh``) stops before its records on
this JAX version, so the reference planner over ``StandInMesh`` and the
port's real gloo runs are the oracles."""
import dataclasses
import functools
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.core.ver import build_bank as jbuild_bank
from repro.launch import shapes as jshapes
from repro.launch.sharding import ShardingPlanner as JPlanner
from repro.models import init_caches as jinit_caches
from repro.models import init_params as jinit_params
from repro.training.adamw import adamw_init as jadamw_init
from repro_torch.configs import get_config
from repro_torch.core import tree as T
from repro_torch.core.ver import build_bank, build_bank_empty
from repro_torch.launch import dist as D
from repro_torch.launch import dryrun, shapes
from repro_torch.launch import sharding as SH
from repro_torch.launch.dist import DistContext
from repro_torch.launch.mesh import dry_context, make_production_mesh, spawn
from repro_torch.models.model import init_params
from torch_threads import _one_thread  # noqa: F401

import torch_dryrun_worker as DW
import torch_specs_worker as W

#: The decoder-only attention stacks, then the families (Mamba-2's
#: contraction-sharded mixer, the hybrid stack, the encoder-decoder and
#: the VLM): every assigned arch.
DECODERS = ("qwen3-moe-30b-a3b", "granite-moe-1b-a400m", "llama3_2-3b",
            "deepseek-7b", "phi4-mini-3.8b", "h2o-danube-3-4b")
FAMILIES = ("mamba2-130m", "jamba-v0_1-52b", "whisper-tiny",
            "llava-next-34b")
GRIDS = ((False, (16, 16), ("data", "model")),
         (True, (2, 16, 16), ("pod", "data", "model")))


class StandInMesh:
    """What the reference's planner reads of a mesh (``test_torch_mesh``)."""

    def __init__(self, shape, names):
        self.shape = dict(zip(names, shape))
        self.axis_names = tuple(names)


def _reference_dryrun_module():
    """The reference's ``launch/dryrun.py``: its import sets ``XLA_FLAGS``
    for its own process (512 host devices), which is put back here."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jdryrun


# -- (a) the shapes ----------------------------------------------------------
def _fields(cfg):
    return {f.name: (dataclasses.asdict(getattr(cfg, f.name))
                     if dataclasses.is_dataclass(getattr(cfg, f.name))
                     else getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)}


def test_shapes_match_reference():
    """SHAPES, SKIPS, LONG_SWA_WINDOW and ASSIGNED as the reference's;
    ``arch_for_shape`` gives the reference's config field by field for
    every arch × shape (the 500k window on full-attention stacks)."""
    assert shapes.SHAPES == jshapes.SHAPES
    assert shapes.SKIPS == jshapes.SKIPS
    assert shapes.LONG_SWA_WINDOW == jshapes.LONG_SWA_WINDOW
    assert dryrun.ASSIGNED == _reference_dryrun_module().ASSIGNED
    for arch in JARCH_IDS:
        for shape in jshapes.SHAPES:
            got = _fields(shapes.arch_for_shape(arch, shape))
            want = _fields(jshapes.arch_for_shape(arch, shape))
            assert got == want, (arch, shape)


def test_production_mesh():
    g = make_production_mesh()
    assert (g.shape, g.axis_names) == ({"data": 16, "model": 16},
                                       ("data", "model"))
    g = make_production_mesh(multi_pod=True)
    assert (g.shape, g.axis_names) == ({"pod": 2, "data": 16, "model": 16},
                                       ("pod", "data", "model"))
    with D.dry_run():
        last = dry_context(g, 511)
    assert (last.data_rank, last.data_size, last.rank, last.model_size) == \
        (31, 32, 15, 16)
    assert last.device.type == "meta" and last.group is None


# -- (b) per-rank bytes against the reference planner -------------------------
def _per_rank(tree, kind, planner, mesh) -> int:
    """One rank's bytes of a reference tree under its planner's specs."""
    fn = getattr(planner, f"spec_for_{kind}")
    total = 0
    for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        shape = tuple(leaf.shape)
        size = int(jnp.dtype(leaf.dtype).itemsize)
        for d in shape:
            size *= d
        for entry in fn(jax.tree_util.keystr(kp), shape):
            names = () if entry is None else \
                (entry,) if isinstance(entry, str) else tuple(entry)
            for a in names:
                size //= mesh.shape[a]
        total += size
    return total


def _reference_bytes(arch, shape, mesh, nsb):
    """What each argument of the reference's ``build_dryrun`` holds per
    rank, from its planner's specs over its ``jax.eval_shape`` trees."""
    info = jshapes.SHAPES[shape]
    cfg = jshapes.arch_for_shape(arch, shape)
    if nsb is not None:            # the reference's ``nsb_override``
        cfg = dataclasses.replace(
            cfg, n_layers=len(cfg.superblock_or_default()) * nsb,
            n_encoder_layers=min(cfg.n_encoder_layers, nsb)
            if cfg.is_encoder_decoder else 0)
    train = info["kind"] == "train"
    pl = JPlanner(cfg, mesh, fsdp=train)
    B, S = info["batch"], info["seq"]
    params = jax.eval_shape(lambda: jinit_params(jax.random.PRNGKey(0), cfg))
    if train:
        opt = jax.eval_shape(jadamw_init, params)
        batch = jshapes._token_inputs(cfg, B, S)
        batch["labels"] = jax.ShapeDtypeStruct(batch["tokens"].shape,
                                               jnp.int32)
        return {"params": _per_rank(params, "param", pl, mesh),
                "adamw": _per_rank(opt, "param", pl, mesh),
                "inputs": _per_rank(batch, "input", pl, mesh)}
    out = {}
    if cfg.is_moe:
        E, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
        nh = min(E, max(mesh.shape["model"], E // 8))
        nsb_ = cfg.n_superblocks()
        ew = {"w_gate": jax.ShapeDtypeStruct((nsb_, E, d, f), jnp.bfloat16),
              "w_up": jax.ShapeDtypeStruct((nsb_, E, d, f), jnp.bfloat16),
              "w_down": jax.ShapeDtypeStruct((nsb_, E, f, d), jnp.bfloat16)}
        bank = {str(p): jax.eval_shape(
            lambda w: jbuild_bank(w, n_hi=nh, lo_bits=4), ew)
            for p in range(len(cfg.superblock_or_default()))
            if cfg.ffn_kind(p) == "moe"}
        out["bank"] = _per_rank(bank, "param", pl, mesh)
        params = jax.eval_shape(lambda p: jshapes._strip_experts(p, cfg),
                                params)
    out["params"] = _per_rank(params, "param", pl, mesh)
    caches = jax.eval_shape(lambda: jinit_caches(cfg, B, S))
    out["caches"] = _per_rank(caches, "cache", pl, mesh)
    if info["kind"] == "prefill":
        out["inputs"] = _per_rank(jshapes._token_inputs(cfg, B, S), "input",
                                  pl, mesh)
    else:
        out["token"] = _per_rank(jax.ShapeDtypeStruct((B,), jnp.int32),
                                 "input", pl, mesh)
        out["pos"] = 4                      # P(): every rank holds it
    return out


def _port_bytes(arch, shape, multi, nsb):
    """Every rank's held bytes by argument for rank 0 and the last rank."""
    with D.dry_run():
        spec = shapes.build_dryrun(arch, shape,
                                   make_production_mesh(multi_pod=multi),
                                   nsb_override=nsb)
        return [spec.rank(r)[2] for r in (0, spec.chips - 1)]


@pytest.mark.parametrize("arch", DECODERS + FAMILIES)
def test_rank_bytes_match_reference_planner(arch):
    """At 2 super-blocks (2 encoder layers), the four shapes (Whisper's
    three) on both grids: rank 0's and the last rank's bytes of each
    argument equal the reference's, to the byte."""
    for shape in jshapes.SHAPES:
        if (arch, shape) in jshapes.SKIPS:
            continue
        for multi, shp, names in GRIDS:
            want = _reference_bytes(arch, shape, StandInMesh(shp, names), 2)
            for got in _port_bytes(arch, shape, multi, 2):
                assert got == want, (arch, shape, shp)


# -- (c) the recording mode against gloo --------------------------------------
def _moe_setup(dev):
    """The reduced 30B (params without experts, its bank {"0": bank} of 2
    hi slots at int4, group 32), on ``dev`` ("meta": shapes only)."""
    cfg = get_config("qwen3-moe-30b-a3b", reduced=True)
    params = init_params(cfg, device=dev) if dev == "meta" else \
        init_params(cfg, seed=3, device=dev)
    experts = params["blocks"]["0"]["moe"].pop("experts")
    params["blocks"]["0"]["moe"]["experts"] = None
    if dev == "meta":
        bank = build_bank_empty({k: tuple(v.shape)
                                 for k, v in experts.items()},
                                n_hi=2, lo_bits=4, group_size=32,
                                device="meta")
    else:
        bank = build_bank(experts, n_hi=2, lo_bits=4, group_size=32)
    return cfg, params, {"0": bank}


def _train_setup(dev):
    cfg = get_config("granite-moe-1b-a400m", reduced=True)
    params = init_params(cfg, device=dev) if dev == "meta" else \
        init_params(cfg, seed=4, device=dev)
    return cfg, T.tree_map(lambda t: t.float(), params)


def _tokens(vocab, B, n, dev, seed):
    if dev == "meta":
        return torch.empty((B, n), dtype=torch.int64, device="meta")
    g = torch.Generator().manual_seed(seed)
    return torch.randint(1, vocab, (B, n), generator=g)


#: name → (kind, rows, dispatch, ep).
CASES = {"serve_8": ("serve", 8, "padded", False),
         "serve_2": ("serve", 2, "padded", False),
         "serve_8_ep": ("serve", 8, "ragged", True),
         "train": ("train", 4, None, False)}


def _setup(dev):
    out = {}
    cfg, params, bank = _moe_setup(dev)
    tcfg, tparams = _train_setup(dev)
    for i, (name, (kind, B, dispatch, ep)) in enumerate(CASES.items()):
        if kind == "serve":
            toks = _tokens(cfg.vocab_size, B, W.S + 1, dev, i)
            out[name] = ("serve", (cfg, params, bank, toks),
                         dict(dispatch=dispatch, ep=ep))
        else:
            toks = _tokens(tcfg.vocab_size, B, W.TRAIN_S + 1, dev, i)
            out[name] = ("train", (tcfg, tparams, toks), {})
    return out


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    return spawn(DW.world, 2, "cpu", _setup("cpu"), n_data=2, threads=1,
                 tmpdir=str(tmp_path_factory.mktemp("dryrun")))


def _recorded(rank):
    """The worker's runs for ``rank`` of the 2 × 2 grid, on meta under the
    recording mode."""
    grid = SH.GridShape({"data": 2, "model": 2}, ("data", "model"))
    with D.dry_run():
        ctx = dry_context(grid, rank)
        out = {"coords": (ctx.data_rank, ctx.rank),
               "collectives": DW.collectives(ctx)}
        run = {"serve": DW.serve_sent, "train": DW.train_sent}
        for name, (kind, args, kw) in _setup("meta").items():
            out[name] = run[kind](*args, ctx, **kw)
    return out


@pytest.mark.parametrize("rank", [0, 3])
def test_recorded_sent_bytes_match_gloo(gloo, rank):
    """Rank 0's and rank 3's recorded bytes equal the real run's, by
    collective and axis, for every collective over every axis (and the
    results' shapes), prefill and decode at 8 rows (padded and all-to-all
    regimes) and 2 rows (the caches' sequence over model), and the FSDP
    train step."""
    got, want = _recorded(rank), gloo[rank]
    assert got["coords"] == want["coords"]
    assert got["collectives"] == want["collectives"]
    for name in CASES:
        assert got[name] == want[name], name
        for phase in got[name].values():
            assert phase, name                  # something was sent


def test_meta_outside_the_dry_run_raises():
    """A meta tensor reaching a collective, a kernel wrapper or
    ``resolve_device`` outside ``dry_run()`` raises; inside it a real
    tensor reaching a collective raises."""
    ctx = DistContext(None, 0, 2, device="cpu")
    m = torch.empty((4, 2), device="meta")
    with pytest.raises(RuntimeError, match="outside"):
        D.all_gather(m, ctx)
    with pytest.raises(RuntimeError, match="outside"):
        D.all_reduce(m, ctx)
    with pytest.raises(ValueError, match="dry run"):
        DistContext(None, 0, 2, device="meta")
    from repro_torch.kernels import ops
    q = torch.empty((1, 2, 64), dtype=torch.bfloat16, device="meta")
    kv = torch.empty((1, 8, 2, 64), dtype=torch.bfloat16, device="meta")
    valid = torch.empty((1, 8), dtype=torch.bool, device="meta")
    with pytest.raises(RuntimeError, match="outside"):
        ops.flash_decode(q, kv, kv, valid)
    with D.dry_run() as dry:
        out = ops.flash_decode(q, kv, kv, valid)
        assert out.shape == (1, 2, 64) and out.device.type == "meta"
        assert dry.kernels["flash_decode"]["calls"] == 1
        with pytest.raises(RuntimeError, match="meta tensors only"):
            D.all_gather(torch.zeros(4), dry_context(
                SH.GridShape({"data": 1, "model": 2}, ("data", "model")),
                0))
        table = torch.empty((1, 1), dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="no meta branch"):
            ops.flash_decode_paged(q, torch.empty((2, 2, 16, 64),
                                                  dtype=torch.bfloat16,
                                                  device="meta"),
                                   torch.empty((2, 2, 16, 64),
                                               dtype=torch.bfloat16,
                                               device="meta"),
                                   table, torch.empty((1, 16),
                                                      dtype=torch.bool,
                                                      device="meta"))


# -- (d) a full-depth record --------------------------------------------------
def test_full_depth_decode_record():
    """The 30B × decode_32k on 16 × 16 at full depth: rank 0 and rank 255
    record the same, every argument's bytes equal the reference
    planner's, no tensor over 1 MiB is made off ``meta``, every collective
    and kernel of the padded regime's decode is there, and the roofline
    terms are positive."""
    recs = dryrun.run_one("qwen3-moe-30b-a3b", "decode_32k", False,
                          verbose=False)
    assert len(recs) == 1
    rec = recs[0]
    assert rec["ranks"] == [0, 255]
    assert rec["largest_off_meta_bytes"] <= 1 << 20
    want = _reference_bytes("qwen3-moe-30b-a3b", "decode_32k",
                            StandInMesh((16, 16), ("data", "model")), None)
    assert rec["held_bytes"] == want
    assert rec["argument_size_in_bytes"] == sum(want.values())
    assert rec["regimes"] == {"padded": 48}
    assert rec["kernels"]["flash_decode"]["calls"] == 48
    assert rec["kernels"]["grouped_lo_matmul"]["calls"] == 3 * 48
    assert set(rec["sent_bytes"]) == {"all_gather", "all_reduce"}
    rl = rec["roofline"]
    assert rl["t_compute_s"] > 0 and rl["t_memory_s"] > 0 and \
        rl["t_collective_s"] > 0
    assert rec["fits_80gb_hbm"] is True
    assert rec["temp_size_in_bytes"] > 0


# -- (e) the command line -----------------------------------------------------
SUBSET = ("granite-moe-1b-a400m", "jamba-v0_1-52b", "mamba2-130m",
          "whisper-tiny", "llava-next-34b")


def test_main_lines(tmp_path, monkeypatch, capsys):
    """``--all --mesh both`` over a subset of the assigned archs (granite
    and the four families) at one super-block: an OK line for every cell
    but Whisper × long_500k, SKIP for it on each grid, no error line; each
    record's rank 0 and last rank agree."""
    monkeypatch.setattr(dryrun, "ASSIGNED", SUBSET)
    monkeypatch.setattr(dryrun, "run_one",
                        functools.partial(dryrun.run_one, nsb=1))
    out = tmp_path / "dry.jsonl"
    recs = dryrun.main(["--all", "--mesh", "both", "--out", str(out)])
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert lines == json.loads(json.dumps(recs))
    assert len(lines) == len(SUBSET) * 4 * 2
    printed = capsys.readouterr().out.splitlines()
    for rec in lines:
        tag = (rec["arch"], rec["shape"])
        if tag == ("whisper-tiny", "long_500k"):
            assert rec["skipped"] == shapes.SKIPS[tag]
        else:
            assert "error" not in rec, (tag, rec.get("error"))
            assert "roofline" in rec and rec["ranks"] == \
                ([0, 255] if rec["mesh"] == "16x16" else [0, 511]), tag
            assert rec["largest_off_meta_bytes"] <= 1 << 20, tag
    assert sum(x.startswith("OK ") for x in printed) == 38
    assert sum(x.startswith("SKIP ") for x in printed) == 2
    assert sum(x.startswith("FAIL ") for x in printed) == 0
    assert printed[-1].startswith("done: 38 ok, 0 failed, 2 skipped")


def test_module_exits_1_on_a_failure():
    """``python -m repro_torch.launch.dryrun`` exits 1 when a cell failed
    (as the reference's), and prints its error line: here an arch the
    registry lacks."""
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "no-such-arch", "--shape", "decode_32k"],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 1, r.stdout + r.stderr
    assert "FAIL no-such-arch×decode_32k×16x16: KeyError" in r.stdout
