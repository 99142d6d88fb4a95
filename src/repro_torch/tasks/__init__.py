"""The task subsystem (DESIGN.md §12), the port's copy of ``repro.tasks``:
LambdaMART ranking, honest uplift trees and isolation forests, all routed
through the existing growers and compiled serving engines.

Importing this package registers the task-specific learners; the RANKING
task needs no learner of its own — it is a loss on GRADIENT_BOOSTED_TREES
(``repro_torch.tasks.ranking.LambdaMARTLoss``, wired in core/gbt.py).
"""
from repro_torch.tasks.isolation import IsolationForestLearner  # noqa: F401
from repro_torch.tasks.ranking import (  # noqa: F401
    GroupLayout,
    LambdaMARTLoss,
    group_aware_split,
    group_layout,
    lambda_grad_batched,
    lambda_grad_naive,
)
from repro_torch.tasks.uplift import UpliftTreesLearner  # noqa: F401
