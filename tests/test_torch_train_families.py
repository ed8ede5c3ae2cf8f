"""Every family in the port's registry trains: the port's counterpart of
the reference's ``tests/test_models_smoke.py::
test_smoke_forward_and_train_step``, held against the reference on the
reduced configurations (weights built by ``repro.models.init_params`` and
carried over by ``convert``; tokens, labels and the stub frontends'
frames and patches drawn with numpy from a seed and fed to both):

* ``forward_train``'s logits: finite, of the reference's shape (the image
  prefix included), and within the tolerance where routing agrees;
* one ``make_train_step`` step (remat, padded dispatch): a finite loss
  and gradient norm, the reference's loss, and every parameter matrix
  moved.

Routing first (ROADMAP's parity hazards): a router near tie can move one
token's assignment to another expert in one package, and that token's
logits then differ by O(1). Per MoE position the two packages' counts
have the same total; the assignments they place differently (half the L1
distance of the counts) are the swaps, and at most 2 positions per swap
may exceed the tolerance (the token itself and, through attention or the
SSD state, a neighbour). Without a swap every position is held.

The reference's forward and jitted step run once per family and module
(``_reference``). The MoE and hybrid stacks, whose reference steps take
longest to compile, run from ``test_torch_train_moe_families.py`` through
the same checks (``check_forward``, ``check_step``), so the two files
share the workers."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import forward_train as jforward_train
from repro.models import init_params as jinit_params
from repro.training import TrainConfig as JTrainConfig
from repro.training import make_train_step as jmake_train_step
from repro.training.adamw import AdamWConfig as JAdamWConfig
from repro.training.adamw import adamw_init as jadamw_init
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import params_from_reference, to_torch
from repro_torch.core import tree as T
from repro_torch.models.model import forward_train
from repro_torch.training import (AdamWConfig, TrainConfig, adamw_init,
                                  make_train_step)
from torch_threads import _one_thread  # noqa: F401

B, S = 2, 32
#: Logits where routing agrees: the families suites' bound on two-layer
#: stacks, and the hybrid suite's on Jamba's eight (its stack amplifies
#: ulps; ROADMAP's parity hazards).
LOGIT_TOL = {"jamba-v0_1-52b": 0.25}
LOGIT_TOL_DEFAULT = 0.05
#: The step's loss against the reference's: absolute (a swapped token's
#: cross-entropy moves the mean over 64 positions by ~0.005).
LOSS_TOL = 0.01
_REF = {}
#: The families of this file; the MoE and hybrid stacks are the other's.
MOE_FAMILIES = ("qwen3-moe-30b-a3b", "qwen3-moe-80b-a3b",
                "granite-moe-1b-a400m", "jamba-v0_1-52b")
FAMILIES = tuple(a for a in ARCH_IDS if a not in MOE_FAMILIES)


def _inputs(cfg):
    """numpy inputs: tokens, labels, and the family's stub frontend."""
    rng = np.random.default_rng(0)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "audio":
        b["audio_embeds"] = (rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(jnp.bfloat16)
    if cfg.family == "vlm":
        b["image_embeds"] = (rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.d_model)) * 0.02) \
            .astype(jnp.bfloat16)
    return b


def _port_batch(b):
    return {k: to_torch(v) if v.dtype.name == "bfloat16"
            else torch.from_numpy(v).long() for k, v in b.items()}


def _reference(arch):
    """(port config, params as numpy, inputs, reference logits, counts,
    reference step metrics) of one family, computed once."""
    if arch not in _REF:
        jcfg = jget_config(arch, reduced=True)
        jp = jinit_params(jax.random.PRNGKey(0), jcfg)
        b = _inputs(jcfg)
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        logits, aux = jforward_train(jp, jcfg, {k: v for k, v in jb.items()
                                                if k != "labels"})
        step = jax.jit(jmake_train_step(
            jcfg, JTrainConfig(optimizer=JAdamWConfig(lr=1e-3))))
        _, _, m = step(jp, jadamw_init(jp), jb)
        _REF[arch] = (get_config(arch, reduced=True),
                      jax.tree_util.tree_map(np.asarray, jp), b,
                      np.asarray(logits),
                      {k: np.asarray(v) for k, v in aux["counts"].items()},
                      {k: float(v) for k, v in m.items()})
    return _REF[arch]


def test_registry_is_the_reference_s():
    from repro.configs import ARCH_IDS as JARCH_IDS
    assert sorted(ARCH_IDS) == sorted(JARCH_IDS)
    assert set(MOE_FAMILIES) <= set(ARCH_IDS)


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_train_matches_reference(arch):
    check_forward(arch)


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_matches_reference(arch):
    check_step(arch)


def check_forward(arch):
    cfg, npp, b, want, jcounts, _ = _reference(arch)
    logits, aux = forward_train(params_from_reference(npp), cfg,
                                {k: v for k, v in _port_batch(b).items()
                                 if k != "labels"})
    S_out = S + (cfg.num_image_tokens if cfg.family == "vlm" else 0)
    assert logits.shape == (B, S_out, cfg.vocab_size) == want.shape
    assert bool(torch.isfinite(logits).all())
    assert aux["counts"].keys() == jcounts.keys()
    swaps = 0
    for k, c in aux["counts"].items():
        c = c.numpy()
        assert c.shape == jcounts[k].shape
        assert np.array_equal(c.sum(-1), jcounts[k].sum(-1)), k
        swaps += int(np.abs(c - jcounts[k]).sum()) // 2
    err = np.abs(logits.numpy() - want).max(-1)
    tol = LOGIT_TOL.get(arch, LOGIT_TOL_DEFAULT)
    assert int((err > tol).sum()) <= 2 * swaps, (swaps, np.sort(err.ravel())
                                                 [-4:])
    assert float(aux["aux_loss"]) >= 0.0


def check_step(arch):
    cfg, npp, b, _, _, jm = _reference(arch)
    p = params_from_reference(npp)
    p2, s2, m = make_train_step(
        cfg, TrainConfig(optimizer=AdamWConfig(lr=1e-3)))(
            p, adamw_init(p), _port_batch(b))
    assert set(m) == set(jm)
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["gnorm"]))
    assert abs(float(m["loss"]) - jm["loss"]) <= LOSS_TOL
    assert int(s2["step"]) == 1
    moved = [not torch.equal(a, c) for a, c in zip(T.leaves(p),
                                                   T.leaves(p2))]
    assert any(moved)
    for path, a, mv in zip(T.flatten(p)[0], T.leaves(p), moved):
        if a.dim() >= 3 and not path.endswith("scale"):
            assert mv, path
