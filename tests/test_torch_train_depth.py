"""Training in the port against the reference at granite's full depth (24
layers) on the reduced width (d 256, 4 experts top-2), in float32: the
structure of the backward through every layer (remat's recompute, the
per-layer views of the stacked leaves, their gradients stacked back) held
to the reference without bf16 noise.

In bf16 at this depth both packages' gradients sit tens of percent
(relative L2) from a float32 step and from each other: a fault in one
layer would hide in that. In float32 they agree to ~1e-5.

A multi-step trajectory is held over its first steps only: two correct
float32 implementations part as they train, from the fourth step on on
this stack, because Adam's early steps move every parameter by ~lr
whatever its gradient's size (an element near zero whose sign differs
moves its parameter by 2 lr), and routing near-ties then flip.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.training import TrainConfig as JTrainConfig
from repro.training import loss_fn as jloss_fn
from repro.training import train_loop as jtrain_loop
from repro.training.adamw import AdamWConfig as JAdamWConfig
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.core import tree as T
from repro_torch.training import (AdamWConfig, SyntheticLMTask, TrainConfig,
                                  train_loop)
from repro_torch.training.train import _grads, to_batch
from torch_threads import _one_thread  # noqa: F401

ARCH = "granite-moe-1b-a400m"
#: Granite's depth at full size.
LAYERS = 24
#: Loss terms (ce, aux, z and the total) agree to this relative error in
#: float32 (seen ≤ 4e-7).
LOSS_RTOL = 1e-5
#: Per-leaf relative L2 error of float32 gradients (seen 1.4e-5 at most).
GRAD_RTOL = 1e-4
#: Steps of the trajectory held, and the gradient norm's relative error
#: over them (seen ≤ 8e-6).
STEPS = 3
GNORM_RTOL = 1e-4
_W = {}


def _f32(tree):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
        tree)


def _weights():
    """(reference config, port config, reference float32 params, port
    float32 params): the reference's seeded weights at 24 layers, once."""
    if not _W:
        jcfg = dataclasses.replace(jget_config(ARCH, reduced=True),
                                   n_layers=LAYERS)
        cfg = dataclasses.replace(get_config(ARCH, reduced=True),
                                  n_layers=LAYERS)
        jp = jinit_params(jax.random.PRNGKey(0), jcfg)
        p = params_from_reference(jax.tree_util.tree_map(np.asarray, jp))
        _W["w"] = (jcfg, cfg, _f32(jp), T.tree_map(lambda t: t.float(), p))
    return _W["w"]


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


@pytest.mark.parametrize("remat", [True, False])
def test_float32_gradients_at_full_depth_match_reference(remat):
    """One batch through 24 layers: every layer's router counts equal, the
    loss terms within LOSS_RTOL, every gradient leaf (in the reference's
    flatten order) float32 and within GRAD_RTOL relative L2."""
    jcfg, cfg, jp, p = _weights()
    b = next(SyntheticLMTask(cfg.vocab_size, seed=0).batches(8, 33, 1))
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (jt, jm), jg = jax.value_and_grad(
        lambda q: jloss_fn(q, jcfg, jb, JTrainConfig(remat=remat)),
        has_aux=True)(jp)
    loss, m, grads = _grads(p, cfg, to_batch(b, "cpu"),
                            TrainConfig(remat=remat))
    assert np.array_equal(m["counts"]["0"].numpy(),
                          np.asarray(jm["counts"]["0"]))
    assert m["counts"]["0"].shape[0] == LAYERS
    for k in ("ce", "aux", "z"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(float(loss), float(jt), rtol=LOSS_RTOL)
    jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
    paths = T.flatten(p)[0]
    assert len(jflat) == len(grads) == len(paths)
    for (jpath, ja), path, g in zip(jflat, paths, grads):
        assert jax.tree_util.keystr(jpath).replace("']['", "/") \
            .strip("[']") == path
        assert g.dtype == torch.float32, path
        assert _rel_l2(g.numpy(), np.asarray(ja)) <= GRAD_RTOL, path


def test_float32_trajectory_at_full_depth_matches_reference():
    """``train_loop`` at the launcher's settings (lr 2e-3, 10 warmup steps,
    remat), STEPS steps of 8 x 32 tokens in both packages: each step's
    loss, ce and aux within LOSS_RTOL and its gradient norm within
    GNORM_RTOL of the reference's."""
    jcfg, cfg, jp, p = _weights()
    task = SyntheticLMTask(cfg.vocab_size, seed=0)
    _, _, jh = jtrain_loop(jcfg, jp, task.batches(8, 33, STEPS),
                           JTrainConfig(optimizer=JAdamWConfig(
                               lr=2e-3, total_steps=20)),
                           log_every=1, log=lambda *_: None)
    _, _, th = train_loop(cfg, p, task.batches(8, 33, STEPS),
                          TrainConfig(optimizer=AdamWConfig(
                              lr=2e-3, total_steps=20)),
                          log_every=1, log=lambda *_: None)
    assert [h["step"] for h in th] == [h["step"] for h in jh] == \
        list(range(STEPS))
    for a, b in zip(th, jh):
        for k in ("loss", "ce", "aux"):
            np.testing.assert_allclose(a[k], b[k], rtol=LOSS_RTOL,
                                       err_msg=(a["step"], k))
        np.testing.assert_allclose(a["gnorm"], b["gnorm"], rtol=GNORM_RTOL,
                                   err_msg=a["step"])
