"""DynaExq core of the port: expert banks and handles (``ver``), the byte
budget, slot pools (per shard under expert parallelism), hotness, policy,
the transition pipeline on CUDA streams, the per-layer controller and the
expert-parallel ownership rebalancer (``controller.EPCoordinator``);
parameter trees in the reference's leaf order (``tree``). The reference's
exports."""
from repro_torch.core.allocator import (AllocatorConfig, GlobalAllocator,
                                        TierAssignment)
from repro_torch.core.budget import (UNBOUNDED, BudgetExceeded, BudgetPlan,
                                     BudgetTracker, BudgetView,
                                     HierarchyPlan, plan_budget,
                                     plan_hierarchy)
from repro_torch.core.controller import (ControllerConfig, DynaExqController,
                                         EPCoordinator, RebalanceConfig)
from repro_torch.core.hotness import HotnessEstimator, mask_row_counts
from repro_torch.core.policy import PolicyConfig, select_hi_set
from repro_torch.core.pools import SlotPool
from repro_torch.core.transitions import TransitionManager
from repro_torch.core.ver import (ExpertBankQ, Residency, build_bank,
                                  build_bank_empty, expert_hi_nbytes,
                                  expert_lo_nbytes, publish, unpublish,
                                  write_hi_slot, write_lo_expert)

__all__ = [
    "AllocatorConfig", "GlobalAllocator", "TierAssignment",
    "BudgetTracker", "BudgetView", "BudgetPlan", "HierarchyPlan",
    "UNBOUNDED", "plan_budget", "plan_hierarchy", "BudgetExceeded",
    "ControllerConfig", "DynaExqController", "EPCoordinator",
    "RebalanceConfig", "HotnessEstimator", "mask_row_counts",
    "PolicyConfig", "select_hi_set", "SlotPool", "TransitionManager",
    "ExpertBankQ", "Residency", "build_bank", "build_bank_empty",
    "expert_hi_nbytes", "expert_lo_nbytes", "publish", "unpublish",
    "write_hi_slot", "write_lo_expert",
]
