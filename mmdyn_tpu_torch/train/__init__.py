"""Training: train state and the train / eval / sample steps."""

from mmdyn_tpu_torch.train.state import TrainState, create_train_state
from mmdyn_tpu_torch.train.steps import make_eval_step, make_sample_fn, make_train_step
