"""``repro_torch.ml``: the paper's downstream application (§5.5) — DBPG
ℓ1-logistic regression on a simulated parameter server whose traffic
meter gives Tables 3/4.  A port of ``repro.ml``."""
from .lr import SparseBatch, lr_objective, lr_grad, make_problem  # noqa: F401
from .dbpg import DBPGConfig, soft_threshold, kkt_filter  # noqa: F401
from .ps import PSCluster, PullHandle, PullPlan, TrafficMeter  # noqa: F401
