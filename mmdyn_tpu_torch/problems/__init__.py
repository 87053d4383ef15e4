"""Problem specs: batch parsing, the transforms and the losses of every family."""

from mmdyn_tpu_torch.problems.base import (ProblemConfig, anneal_kl, make_optimizer,
                                           select_compute_dtype)
from mmdyn_tpu_torch.problems.reconstruction import (
    mvae_evaluate,
    regression_evaluate,
    vae_evaluate,
)
from mmdyn_tpu_torch.problems.specs import PROBLEM_PARSERS, evaluate, parse_batch
