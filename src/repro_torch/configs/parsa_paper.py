"""The paper's own experiment configuration (§5): dataset analogues,
partitioner hyper-parameters, and the DBPG application settings.  A copy
of ``repro.configs.parsa_paper``."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ParsaExperimentConfig:
    k: int = 16                # partitions (paper default)
    a: int = 16                # init iterations (paper: a=b=16 for Table 2)
    b: int = 16                # subgraphs
    theta: int = 1000          # bucket head-pointer range (§4.1)
    tau: int | None = None     # max delay; None = eventual consistency (§5.4)
    workers: int = 4           # per-machine workers (§5.4)
    select: str = "size"       # grow smallest |U_i| (perfect balance, §4.1)
    trials: int = 10           # paper averages 10 trials
    # DBPG application (§5.5)
    lam: float = 1.0
    lr: float = 0.05
    dbpg_passes: int = 45      # paper: 45 data passes
    bandwidth: float = 125e6   # 1 GbE university cluster
    machines: int = 16


PAPER = ParsaExperimentConfig()
