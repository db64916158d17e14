from .train_step import make_eval_step, make_train_step  # noqa: F401
