from ddw_tpu_torch.tune.space import uniform, loguniform, quniform, choice, choice_of, ChoiceOf, sample_space  # noqa: F401
from ddw_tpu_torch.tune.tpe import fmin, Trials, STATUS_OK, STATUS_FAIL  # noqa: F401
from ddw_tpu_torch.tune.pruner import (ASHAPruner, MedianPruner, Pruned,  # noqa: F401
                                 RankReporter, STATUS_PRUNED, Trial,
                                 TrialLink, make_pruner)
