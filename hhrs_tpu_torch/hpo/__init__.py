"""Hyperparameter optimization (counterpart of ``hhrs_tpu/hpo``).

The reference drives a 300-trial Optuna study (TPE sampler, MedianPruner,
resumable journal — reference train.py:303-325). This package keeps its
own copies of the JAX package's pure-Python pieces — the trial API
(``suggest_categorical`` / ``suggest_int`` / ``suggest_float``), the
univariate TPE sampler, the pruners, the crash-safe JSONL journal — so a
journal either package writes resumes in the other, and ``create_study(...,
backend="optuna")`` delegates to Optuna where it is installed. Trials train
through the port's ``train_dcn``, or K at a time through
``hpo/vectorized.py::run_group`` on the trial-axis cross kernels.
"""

from hhrs_tpu_torch.hpo.pruner import MedianPruner, NopPruner, SuccessiveHalvingPruner
from hhrs_tpu_torch.hpo.sampler import RandomSampler, TPESampler
from hhrs_tpu_torch.hpo.space import reference_search_space
from hhrs_tpu_torch.hpo.study import Study, Trial, TrialPruned

__all__ = [
    "MedianPruner",
    "NopPruner",
    "SuccessiveHalvingPruner",
    "RandomSampler",
    "TPESampler",
    "reference_search_space",
    "Study",
    "Trial",
    "TrialPruned",
]
