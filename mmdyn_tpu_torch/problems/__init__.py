"""Problem specs: batch parsing and the subset-ELBO loss."""

from mmdyn_tpu_torch.problems.base import ProblemConfig, anneal_kl, make_optimizer
from mmdyn_tpu_torch.problems.reconstruction import mvae_evaluate
from mmdyn_tpu_torch.problems.specs import PROBLEM_PARSERS, evaluate, parse_batch
