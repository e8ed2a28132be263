from repro_torch.training.optimizer import AdamWConfig, apply_update, global_norm, init_opt_state, schedule
from repro_torch.training.steps import make_eval_step, make_train_step, softmax_xent

__all__ = ["AdamWConfig", "init_opt_state", "apply_update", "global_norm", "schedule", "make_train_step",
           "make_eval_step", "softmax_xent"]  # fmt: skip
