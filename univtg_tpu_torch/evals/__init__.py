from univtg_tpu_torch.evals.submission import eval_submission  # noqa: F401
