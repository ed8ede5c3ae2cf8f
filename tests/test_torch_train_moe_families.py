"""The MoE and hybrid stacks of ``test_torch_train_families.py`` (Qwen3-
30B-A3B, the flagship with its shared expert, Granite, Jamba's
Mamba/attention super-block): each one's ``forward_train`` and one train
step against the reference's, by that file's checks and tolerances, in a
file of their own so that the two share the test workers."""
import pytest

from test_torch_train_families import MOE_FAMILIES, check_forward, check_step
from torch_threads import _one_thread  # noqa: F401


@pytest.mark.parametrize("arch", MOE_FAMILIES)
def test_forward_train_matches_reference(arch):
    check_forward(arch)


@pytest.mark.parametrize("arch", MOE_FAMILIES)
def test_train_step_matches_reference(arch):
    check_step(arch)
